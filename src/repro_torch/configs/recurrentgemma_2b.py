"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680.

Griffin layout: (RG-LRU, RG-LRU, local attention window=2048) repeated —
26 layers = 8 full periods + 2 trailing recurrent layers. GeGLU FFN,
head_dim=256, vocab 256000. Recurrent state + local window => sub-quadratic,
runs ``long_500k``. [arXiv:2402.19427]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig,
                                      LayerSpec, ModelConfig,
                                      RecurrentConfig)


@register("recurrentgemma-2b")
def recurrentgemma_2b() -> ModelConfig:
    period = (LayerSpec(mixer="rglru", ffn="geglu"),
              LayerSpec(mixer="rglru", ffn="geglu"),
              LayerSpec(mixer="gqa", ffn="geglu", window=2048))
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        num_layers=26, d_model=2560, d_ff=7680, vocab_size=256000,
        attn=AttentionConfig(num_heads=10, num_kv_heads=1, head_dim=256,
                             rope="rope", rope_theta=10000.0),
        layer_period=period,
        recurrent=RecurrentConfig(width=2560, conv_size=4, lru_c=8.0),
        norm="rmsnorm", act="gelu", embed_scale=True, tie_embeddings=True,
        max_seq_len=8192,
        dist=DistConfig(agents_per_pod=16),
        source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
    )
