"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

RoPE, SwiGLU, GQA (kv=32 == MHA at this size), RMSNorm. [arXiv:2404.14219]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig, LayerSpec,
                                      ModelConfig)


@register("phi3-mini-3.8b")
def phi3_mini() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        num_layers=32, d_model=3072, d_ff=8192, vocab_size=32064,
        attn=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=96,
                             rope="rope", rope_theta=10000.0),
        layer_period=(LayerSpec(mixer="gqa", ffn="swiglu"),),
        norm="rmsnorm", act="silu", tie_embeddings=False,
        max_seq_len=131072,
        dist=DistConfig(agents_per_pod=16),
        source="arXiv:2404.14219 (Phi-3)",
    )
