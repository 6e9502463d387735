"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000.

Dense-MoE hybrid: every layer has a parallel dense residual MLP (d_ff=4864)
plus a 128-expert top-2 MoE (expert d_ff=4864).
[hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig, LayerSpec,
                                      ModelConfig, MoEConfig)


@register("arctic-480b")
def arctic_480b() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, d_ff=4864, vocab_size=32000,
        attn=AttentionConfig(num_heads=56, num_kv_heads=8, head_dim=128,
                             rope="rope", rope_theta=10000.0),
        layer_period=(LayerSpec(mixer="gqa", ffn="moe"),),
        moe=MoEConfig(num_experts=128, top_k=2, expert_ff=4864,
                      dense_ff=4864, router="softmax", capacity_factor=1.25),
        norm="rmsnorm", act="silu", tie_embeddings=False,
        max_seq_len=4096,
        dist=DistConfig(agents_per_pod=2, loss_chunk=1024),
        source="hf:Snowflake/snowflake-arctic-base",
    )
