"""seamless-m4t-medium [audio] — 12L d_model=1024 16H d_ff=4096 vocab=256206.

Encoder-decoder transformer (12 encoder + 12 decoder layers). The
mel-spectrogram + conv feature extractor frontend is a stub: the model takes
precomputed frame embeddings (``batch["frame_embeds"]``, (B, S_src,
d_model)) into its encoder; this config describes the transformer backbone
only. vocab 256206 is padded to 256256 for 16-way TP.
[arXiv:2308.11596]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig, LayerSpec,
                                      ModelConfig)


@register("seamless-m4t-medium")
def seamless_m4t_medium() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        num_layers=12, d_model=1024, d_ff=4096, vocab_size=256206,
        attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64,
                             rope="none"),
        layer_period=(LayerSpec(mixer="gqa", ffn="swiglu"),),
        norm="layernorm", act="relu", tie_embeddings=False,
        max_seq_len=4096, encoder_layers=12, mm_prefix=-1,  # -1: encoder input
        dist=DistConfig(agents_per_pod=16),
        source="arXiv:2308.11596 (SeamlessM4T)",
    )
