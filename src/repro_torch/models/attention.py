"""GQA/MQA attention in train mode (counterpart of ``repro/models/attention.py``).

Scores, the additive mask bias and the softmax are float32; the mask is the
reference's additive ``NEG_INF`` bias, not a boolean fill, so the padded
positions carry exactly the same numbers as in the reference. With
``cfg.dist.attn_block > 0`` attention takes the blockwise online-softmax
route instead (``_sdpa_blockwise``), as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig
from repro_torch.kernels.flash_attention import blockwise_attention
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def init_gqa(generator, cfg: ModelConfig, *, device, dtype=torch.float32):
    a = cfg.attn
    return {
        "wq": dense_init(generator, cfg.d_model, a.q_dim, device=device,
                         dtype=dtype),
        "wk": dense_init(generator, cfg.d_model, a.kv_dim, device=device,
                         dtype=dtype),
        "wv": dense_init(generator, cfg.d_model, a.kv_dim, device=device,
                         dtype=dtype),
        "wo": dense_init(generator, a.q_dim, cfg.d_model, device=device,
                         dtype=dtype),
    }


def _rope_q_or_k(x, positions, a: AttentionConfig):
    if a.rope == "rope":
        return apply_rope(x, positions, a.rope_theta)
    if a.rope == "none":
        return x
    raise NotImplementedError(f"rope kind {a.rope!r} is not ported yet")


def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """q_pos: (..., Sq); k_pos: (..., Sk) -> additive bias (..., Sq, Sk)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)


def _sdpa(q, k, v, bias, scale):
    """q: (B,Sq,H,dq) k: (B,Sk,Kv,dq) v: (B,Sk,Kv,dv) bias: (B,Sq,Sk).

    Returns (B,Sq,H,dv)."""
    B, Sq, H, dq = q.shape
    Kv = k.shape[2]
    dv = v.shape[-1]
    G = H // Kv
    q = q.reshape(B, Sq, Kv, G, dq)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).to(torch.float32) * scale
    scores = scores + bias[:, None, None, :, :]
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", attn, v)  # (B,Sq,Kv,G,dv)
    return out.reshape(B, Sq, H, dv)


def _sdpa_blockwise(q, k, v, q_pos, k_pos, *, causal, window, scale,
                    block: int):
    """Online-softmax attention that never materialises the (Sq, Sk) scores
    (the reference's ``_sdpa_blockwise``). q: (B,Sq,H,dq) k/v: (B,Sk,Kv,d);
    positions (B,Sq), (B,Sk). Returns (B,Sq,H,d).

    On CPU tensors the plain loop over key blocks of ``block``
    (``kernels/ref.py:flash_attention_ref``), differentiated by torch
    autograd; on the card the flash attention kernels, forward and backward
    (``kernels/flash_attention.py:FlashAttention``), whose own tiles stand
    in for ``block``."""
    return blockwise_attention(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, scale=scale, block=block)


def gqa_forward(params, x, *, cfg: ModelConfig, lspec: LayerSpec,
                positions, mode: str = "train", causal=True):
    """Returns (y, None). Only ``mode="train"`` is ported in this slice."""
    if mode != "train":
        raise NotImplementedError(
            f"gqa_forward mode {mode!r}: the port runs train mode only")
    a = cfg.attn
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, a.num_heads, a.head_dim)
    k = (x @ params["wk"]).reshape(B, S, a.num_kv_heads, a.head_dim)
    v = (x @ params["wv"]).reshape(B, S, a.num_kv_heads, a.head_dim)
    q = _rope_q_or_k(q, positions, a)
    k = _rope_q_or_k(k, positions, a)
    scale = 1.0 / math.sqrt(a.head_dim)
    pos_b = torch.broadcast_to(positions, (B, S))
    if cfg.dist.attn_block:
        y = _sdpa_blockwise(q, k, v, pos_b, pos_b, causal=causal,
                            window=lspec.window, scale=scale,
                            block=cfg.dist.attn_block)
    else:
        bias = _mask_bias(pos_b, pos_b, causal=causal, window=lspec.window)
        y = _sdpa(q, k, v, bias, scale)
    y = y.reshape(B, S, a.q_dim) @ params["wo"]
    return y, None
