"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048 vocab=129280.

MLA attention (q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v 128),
MoE with 1 shared + 256 routed experts top-8 (expert d_ff=2048, sigmoid
router), first 3 layers dense (d_ff 18432), MTP depth 1. [arXiv:2412.19437]
"""
from repro_torch.configs import register
from repro_torch.configs.base import (AttentionConfig, DistConfig, LayerSpec,
                                      ModelConfig, MoEConfig)


@register("deepseek-v3-671b")
def deepseek_v3_671b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        num_layers=61, d_model=7168, d_ff=2048, vocab_size=129280,
        attn=AttentionConfig(num_heads=128, num_kv_heads=128, head_dim=128,
                             rope="rope", rope_theta=10000.0,
                             q_lora_rank=1536, kv_lora_rank=512,
                             qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        layer_period=(LayerSpec(mixer="mla", ffn="moe"),),
        moe=MoEConfig(num_experts=256, top_k=8, expert_ff=2048,
                      shared_ff=2048, router="sigmoid", capacity_factor=1.25,
                      aux_loss_weight=0.001),
        norm="rmsnorm", act="silu", tie_embeddings=False,
        max_seq_len=131072, mtp_depth=1,
        dense_ff_first_k=3, dense_ff_size=18432,
        dist=DistConfig(agents_per_pod=2, loss_chunk=1024),
        source="arXiv:2412.19437 (DeepSeek-V3)",
    )
