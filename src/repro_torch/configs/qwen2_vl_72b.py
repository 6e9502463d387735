"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE (temporal/height/width sections), SwiGLU, GQA. The ViT vision encoder +
projector are a stub: the model takes precomputed patch embeddings
(``batch["patch_embeds"]``, (B, mm_prefix, d_model)) as a prefix before the
tokens; this config describes the language transformer backbone only.
[arXiv:2409.12191]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig, LayerSpec,
                                      ModelConfig)


@register("qwen2-vl-72b")
def qwen2_vl_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        num_layers=80, d_model=8192, d_ff=29568, vocab_size=152064,
        attn=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128,
                             rope="mrope", rope_theta=1000000.0,
                             mrope_sections=(16, 24, 24)),  # sums to head_dim/2
        layer_period=(LayerSpec(mixer="gqa", ffn="swiglu"),),
        norm="rmsnorm", act="silu", tie_embeddings=False,
        max_seq_len=32768, mm_prefix=256,
        dist=DistConfig(agents_per_pod=2, loss_chunk=1024),
        source="arXiv:2409.12191 (Qwen2-VL)",
    )
