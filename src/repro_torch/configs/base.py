"""Config dataclasses for models, distribution, and input shapes.

Every assigned architecture gets one ``<arch>.py`` in this package that builds a
:class:`ModelConfig` with the exact pool spec, citing its source in the header.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Attention / mixer configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope: str = "rope"  # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # head_dim/2 split into (t, h, w) parts
    # MLA (deepseek-v3) dims; used when a layer's mixer == "mla"
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    logits_softcap: float = 0.0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int  # d_ff of each routed expert
    shared_ff: int = 0  # d_ff of the always-on shared expert (deepseek); 0 = none
    dense_ff: int = 0  # parallel dense residual MLP (arctic); 0 = none
    router: str = "softmax"  # "softmax" | "sigmoid" (deepseek-v3)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"


@dataclass(frozen=True)
class RecurrentConfig:
    """Parameters for RG-LRU / mLSTM / sLSTM mixers."""

    width: int = 0  # recurrent width (d_rnn); 0 => d_model
    conv_size: int = 4  # temporal conv in the Griffin recurrent block
    num_heads: int = 4  # heads for m/sLSTM
    lru_c: float = 8.0  # RG-LRU exponent scale
    mlstm_chunk: int = 64  # chunk length for chunkwise-parallel mLSTM


# ---------------------------------------------------------------------------
# Layer layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    """One layer = mixer sublayer + (optional) ffn sublayer."""

    mixer: str  # "gqa" | "mla" | "rglru" | "mlstm" | "slstm"
    ffn: str  # "swiglu" | "geglu" | "moe" | "none"
    window: Optional[int] = None  # sliding-window size for local attention


@dataclass(frozen=True)
class DistConfig:
    """How this architecture is laid out on the production pod(s)."""

    agents_per_pod: int = 16  # decentralized agents per 256-chip pod (training)
    # fsdp size is derived: 16 // ... see launch/mesh.py
    remat: str = "full"  # "none" | "full" | "dots"
    scan_layers: bool = True  # False => unroll (dry-run: honest cost_analysis)
    loss_chunk: int = 512  # vocab-chunked CE: tokens per chunk
    attn_block: int = 0  # >0: blockwise online-softmax attention (flash-style
    #                      XLA path; kv processed in chunks of this size)
    seq_shard: bool = False  # sequence-shard the residual stream over 'model'
    moe_dispatch_shard: str = "none"  # "none" | "tokens" | "dmodel" —
    #   shard MoE dispatch gather/scatter over fsdp by tokens or by d_model
    gossip_impl: str = "dense"  # "dense" (paper-faithful W einsum) | "collective"
    gossip_dtype: str = "float32"  # wire dtype for gossip ("bfloat16" = compressed)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | audio | hybrid
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: AttentionConfig
    layer_period: Tuple[LayerSpec, ...]  # cycled to cover num_layers
    moe: Optional[MoEConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    norm: str = "rmsnorm"  # "rmsnorm" | "nonparam_ln" | "layernorm"
    act: str = "silu"
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    tie_embeddings: bool = True
    max_seq_len: int = 8192
    # encoder-decoder (seamless-m4t): encoder depth; 0 => decoder-only
    encoder_layers: int = 0
    # multimodal stub: number of prefix embedding positions fed by the frontend
    mm_prefix: int = 0  # vlm: patch embeddings; audio: frame embeds feed encoder
    mtp_depth: int = 0  # deepseek multi-token-prediction extra blocks
    dense_ff_first_k: int = 0  # deepseek: first k layers use dense FFN
    dense_ff_size: int = 0  # width of those dense layers
    dist: DistConfig = field(default_factory=DistConfig)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    source: str = ""  # citation

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        period = self.layer_period
        reps = (self.num_layers + len(period) - 1) // len(period)
        return tuple(period[i % len(period)] for i in range(self.num_layers))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over 16-way model TP.

        Contract: the LM head projects to ``padded_vocab`` columns and the
        padding tail carries random-init weights — anything that samples
        from head logits MUST mask columns >= ``vocab_size`` to -inf first
        (serving does this in ``repro.serving.engine.sample_token``)."""
        return ((self.vocab_size + 255) // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, d_model: int = 256, layers: Optional[int] = None,
                vocab: int = 512, experts: int = 4) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (<=2 layers, d<=512)."""
        layers = layers if layers is not None else min(2, self.num_layers)
        period = self.layer_period[: max(1, min(len(self.layer_period), layers))]
        head_dim = 32
        n_heads = max(2, d_model // 64)
        n_kv = 1 if self.attn.num_kv_heads == 1 else min(self.attn.num_kv_heads, 2)
        attn = dataclasses.replace(
            self.attn,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=head_dim,
            q_lora_rank=min(self.attn.q_lora_rank, 64) if self.attn.q_lora_rank else 0,
            kv_lora_rank=min(self.attn.kv_lora_rank, 32) if self.attn.kv_lora_rank else 0,
            qk_nope_dim=32 if self.attn.qk_nope_dim else 0,
            qk_rope_dim=16 if self.attn.qk_rope_dim else 0,
            v_head_dim=32 if self.attn.v_head_dim else 0,
            mrope_sections=(8, 4, 4) if self.attn.mrope_sections else (),
        )
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=experts, top_k=min(self.moe.top_k, 2),
                expert_ff=d_model * 2, shared_ff=d_model * 2 if self.moe.shared_ff else 0,
                dense_ff=d_model * 2 if self.moe.dense_ff else 0)
        rec = None
        if self.recurrent is not None:
            rec = dataclasses.replace(
                self.recurrent, width=0, num_heads=2, mlstm_chunk=16)
        period = tuple(
            dataclasses.replace(s, window=min(s.window, 64) if s.window else None)
            for s in period)
        return self.replace(
            num_layers=layers, d_model=d_model, d_ff=d_model * 4,
            vocab_size=vocab, attn=attn, layer_period=period, moe=moe,
            recurrent=rec, max_seq_len=256,
            encoder_layers=min(self.encoder_layers, layers),
            mm_prefix=min(self.mm_prefix, 8),
            mtp_depth=min(self.mtp_depth, 1),
            dense_ff_first_k=min(self.dense_ff_first_k, 1),
            dense_ff_size=d_model * 4 if self.dense_ff_size else 0,
            dist=dataclasses.replace(self.dist, agents_per_pod=4, loss_chunk=64),
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
