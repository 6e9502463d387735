"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU MLP, head_dim=256, RoPE, RMSNorm, embeddings scaled by sqrt(d_model),
tied embeddings. [arXiv:2403.08295]

``long_500k`` support: we expose a sliding-window variant (window=4096, gemma-2
style local attention) selectable via ``gemma_2b_sw()``; the dry-run uses it for
the long-context decode shape (see DESIGN.md §5).
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig, LayerSpec,
                                      ModelConfig)


def _base(window=None) -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense",
        num_layers=18, d_model=2048, d_ff=16384, vocab_size=256000,
        attn=AttentionConfig(num_heads=8, num_kv_heads=1, head_dim=256,
                             rope="rope", rope_theta=10000.0),
        layer_period=(LayerSpec(mixer="gqa", ffn="geglu", window=window),),
        norm="rmsnorm", act="gelu", embed_scale=True, tie_embeddings=True,
        max_seq_len=8192,
        dist=DistConfig(agents_per_pod=16),
        source="arXiv:2403.08295 (Gemma)",
    )


@register("gemma-2b")
def gemma_2b() -> ModelConfig:
    return _base()


@register("gemma-2b-sw")
def gemma_2b_sw() -> ModelConfig:
    """Sliding-window variant used only for the long_500k decode shape."""
    cfg = _base(window=4096)
    return cfg.replace(name="gemma-2b-sw")
