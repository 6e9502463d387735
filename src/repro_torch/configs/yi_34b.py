"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Llama-architecture GQA, SwiGLU, RoPE, RMSNorm. [arXiv:2403.04652]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig, LayerSpec,
                                      ModelConfig)


@register("yi-34b")
def yi_34b() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        num_layers=60, d_model=7168, d_ff=20480, vocab_size=64000,
        attn=AttentionConfig(num_heads=56, num_kv_heads=8, head_dim=128,
                             rope="rope", rope_theta=5000000.0),
        layer_period=(LayerSpec(mixer="gqa", ffn="swiglu"),),
        norm="rmsnorm", act="silu", tie_embeddings=False,
        max_seq_len=4096,
        dist=DistConfig(agents_per_pod=4, loss_chunk=1024),
        source="arXiv:2403.04652 (Yi)",
    )
