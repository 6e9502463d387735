"""olmo-1b [dense] — 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (no learnable scale/bias), SwiGLU, RoPE, no biases.
[arXiv:2402.00838]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig, LayerSpec,
                                ModelConfig)


@register("olmo-1b")
def olmo_1b() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        num_layers=16, d_model=2048, d_ff=8192, vocab_size=50304,
        attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                             rope="rope", rope_theta=10000.0),
        layer_period=(LayerSpec(mixer="gqa", ffn="swiglu"),),
        norm="nonparam_ln", act="silu", tie_embeddings=True,
        max_seq_len=2048,
        dist=DistConfig(agents_per_pod=16),
        source="arXiv:2402.00838 (OLMo)",
    )
