"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks in a 7:1 ratio (xLSTM[7:1]): each period is 7 mLSTM
blocks followed by 1 sLSTM block; 48 layers = 6 periods. ``d_ff=0``: blocks
carry their own up/down projections, there is no separate FFN sublayer.
mLSTM uses the chunkwise-parallel form (sub-quadratic), sLSTM a sequential
scan — both expose O(1)-per-token recurrent decode state, so this arch runs
``long_500k``. [arXiv:2405.04517]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig,
                                      LayerSpec, ModelConfig,
                                      RecurrentConfig)


@register("xlstm-1.3b")
def xlstm_1_3b() -> ModelConfig:
    period = tuple([LayerSpec(mixer="mlstm", ffn="none")] * 7 +
                   [LayerSpec(mixer="slstm", ffn="none")])
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        num_layers=48, d_model=2048, d_ff=0, vocab_size=50304,
        attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=512,
                             rope="none"),
        layer_period=period,
        recurrent=RecurrentConfig(width=0, num_heads=4, mlstm_chunk=64),
        norm="layernorm", act="gelu", tie_embeddings=False,
        max_seq_len=2048,
        dist=DistConfig(agents_per_pod=16),
        source="arXiv:2405.04517 (xLSTM)",
    )
