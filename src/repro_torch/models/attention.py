"""GQA/MQA and MLA attention in train, prefill and decode modes
(counterpart of ``repro/models/attention.py``).

Scores, the additive mask bias and the softmax are float32; the mask is the
reference's additive ``NEG_INF`` bias, not a boolean fill, so the padded
positions carry exactly the same numbers as in the reference. With
``cfg.dist.attn_block > 0`` train and prefill attention take the blockwise
online-softmax route instead (``_sdpa_blockwise``), as in the reference.

Decode uses the reference's cache layout ``{"k", "v", "pos"}``: ``pos``
holds the absolute position of each cache slot (-1 = empty, masked), and a
sliding window allocates only ``window`` slots written round-robin (slot =
pos mod W). The reference returns an updated copy of a donated cache; here
decode writes the new key, value and position into the given cache tensors
in place and returns the same dict.

MLA (deepseek-v3) runs the materialised form in train and prefill, always
through the dense ``_sdpa`` (as the reference: never the blockwise route),
and the absorbed latent-space form in decode over its cache ``{"ckv",
"krope", "pos"}`` (the normalised latent and the rotated shared key of
each position), written per row in place as the GQA cache.

Rotary kinds: "rope", "mrope" (qwen2-vl's t/h/w sections, from
``positions3``) and "none". Cross attention (seamless-m4t's decoder)
attends to the encoder's keys and values, projected once (``cross_kv``)
and cached as ``{"k", "v", "pos"}``, through the plain ``_sdpa``.

Each family has the reference's logical specs (``spec_gqa``,
``spec_gqa_cache``, ``spec_mla``, ``spec_mla_cache``, ``spec_cross``).
On the split route (``models/tensor_parallel.py``) ``gqa_forward`` takes
a ``split`` in every mode and runs on the rank's heads; in prefill and
decode it writes the rank's block of the cache (its kv heads where the
model line divides them, else all of them).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig
from repro_torch.kernels.flash_attention import blockwise_attention
from repro_torch.models.layers import (apply_mrope, apply_norm, apply_rope,
                                       dense_init)

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


def spec_gqa():
    return {"wq": ("fsdp", "model"), "wk": ("fsdp", "model"),
            "wv": ("fsdp", "model"), "wo": ("model", "fsdp")}


def _rope_q_or_k(x, positions, a: AttentionConfig, positions3=None):
    if a.rope == "rope":
        return apply_rope(x, positions, a.rope_theta)
    if a.rope == "mrope":
        return apply_mrope(x, positions3, a.mrope_sections, a.rope_theta)
    if a.rope == "none":
        return x
    raise ValueError(f"rope kind {a.rope!r}")


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
                positions, mode: str = "train", cache=None, positions3=None,
                causal=True, cache_max_len=None, split=None):
    """Returns (y, new_cache). mode in {"train", "prefill", "decode"}:
    train returns no cache; prefill a fresh one sized ``cache_max_len``
    (default S); decode (S == 1, ``positions`` (B, 1), each row at its own
    depth) writes into ``cache`` in place and returns it. ``positions3``
    (3, B, S) are M-RoPE's t/h/w positions (rope "mrope" only).

    ``split`` (``tensor_parallel.Split`` whose ``attn(a)`` holds) runs
    the rank's H / M query heads: ``wq`` and ``wo`` are its blocks,
    ``wk``/``wv`` its Kv / M heads' columns where M divides Kv, else whole,
    the rank reading the one kv head its query heads share; x enters
    through ``split.copy_in``, the output leaves through
    ``split.reduce_out``. Its cache (prefill, decode) holds the kv heads it
    computes: its Kv / M where M divides Kv, else all Kv (as
    ``spec_gqa_cache`` resolves on the serve mesh)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"gqa_forward mode {mode!r}: train, prefill or "
                         "decode")
    a = cfg.attn
    B, S, _ = x.shape
    H, Kv = a.num_heads, a.num_kv_heads
    if split is not None:
        x = split.copy_in(x)
        H, kv0, Kv = split.local_heads(a)
    q = (x @ params["wq"]).reshape(B, S, H, a.head_dim)
    k = (x @ params["wk"]).reshape(B, S, -1, a.head_dim)
    v = (x @ params["wv"]).reshape(B, S, -1, a.head_dim)
    q = _rope_q_or_k(q, positions, a, positions3)
    k = _rope_q_or_k(k, positions, a, positions3)

    def read(kk, vv):
        """The kv heads the rank's query heads read (all but on a split
        rank sharing one kv head of several)."""
        if split is not None and kk.shape[2] != Kv:
            return kk[:, :, kv0:kv0 + Kv], vv[:, :, kv0:kv0 + Kv]
        return kk, vv

    scale = 1.0 / math.sqrt(a.head_dim)
    new_cache = None
    if mode == "decode":
        # every row writes at its OWN absolute position: under continuous
        # batching each slot sits at a different depth, so this is a
        # per-row scatter, not a shared slice write
        W = cache["k"].shape[1]
        idx = positions[:, 0].to(torch.int64)
        slots = torch.remainder(idx, W)
        rows = torch.arange(B, device=x.device)
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        ck.index_put_((rows, slots), k[:, 0].to(ck.dtype))
        cv.index_put_((rows, slots), v[:, 0].to(cv.dtype))
        cpos.index_put_((rows, slots), idx.to(cpos.dtype))
        bias = _mask_bias(positions, cpos, causal=causal, window=lspec.window)
        y = _sdpa(q, *read(ck, cv), bias, scale)
        new_cache = cache
    else:
        pos_b = torch.broadcast_to(positions, (B, S))
        ka, va = read(k, v)
        if cfg.dist.attn_block:
            y = _sdpa_blockwise(q, ka, va, pos_b, pos_b, causal=causal,
                                window=lspec.window, scale=scale,
                                block=cfg.dist.attn_block)
        else:
            bias = _mask_bias(pos_b, pos_b, causal=causal,
                              window=lspec.window)
            y = _sdpa(q, ka, va, bias, scale)
        if mode == "prefill":
            new_cache = _prefill_cache(lspec, k, v, positions, B, S,
                                       cache_max_len or S)
    y = y.reshape(B, S, H * a.head_dim) @ params["wo"]
    if split is not None:
        y = split.reduce_out(y)
    return y, new_cache


def _prefill_cache(lspec: LayerSpec, k, v, positions, B, S, max_len):
    """The prompt's k, v and positions as a cache of ``cache_len`` slots:
    zero-padded (pos -1) when it holds the whole prompt, else the trailing
    window laid out so that slot = pos mod W (the ring decode writes)."""
    W = cache_len(lspec, max_len)
    pos = torch.broadcast_to(positions, (B, S)).to(torch.int32)
    if W >= S:
        pad = W - S
        ck = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        cv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cpos = torch.nn.functional.pad(pos, (0, pad), value=-1)
    else:
        tail_k, tail_v, tail_p = k[:, S - W:], v[:, S - W:], pos[:, S - W:]
        slots = torch.remainder(tail_p[0], W)  # the same for every row
        inv = torch.argsort(slots)
        ck, cv, cpos = tail_k[:, inv], tail_v[:, inv], tail_p[:, inv]
    return {"k": ck, "v": cv, "pos": cpos}


def cache_len(lspec: LayerSpec, seq_len: int) -> int:
    """Cache slots of a layer: the window where it has one, else
    ``seq_len``."""
    return min(lspec.window, seq_len) if lspec.window else seq_len


def init_gqa_cache(cfg: ModelConfig, lspec: LayerSpec, B: int, seq_len: int,
                   *, device, dtype=torch.float32, kv_heads=None):
    """An empty cache: k and v (B, W, Kv, hd) zeros, pos (B, W) int32 -1
    (``kv_heads``: a split rank's Kv / M instead of Kv)."""
    a = cfg.attn
    W = cache_len(lspec, seq_len)
    Kv = kv_heads or a.num_kv_heads
    return {"k": torch.zeros((B, W, Kv, a.head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((B, W, Kv, a.head_dim), dtype=dtype,
                             device=device),
            "pos": torch.full((B, W), -1, dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


def init_mla(generator, cfg: ModelConfig, *, device, dtype=torch.float32):
    a = cfg.attn
    H = a.num_heads

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, device=device, dtype=dtype)

    return {
        "wq_a": dense(cfg.d_model, a.q_lora_rank),
        "q_norm": {"scale": torch.ones((a.q_lora_rank,), device=device,
                                       dtype=dtype)},
        "wq_b": dense(a.q_lora_rank, H * (a.qk_nope_dim + a.qk_rope_dim)),
        "wkv_a": dense(cfg.d_model, a.kv_lora_rank + a.qk_rope_dim),
        "kv_norm": {"scale": torch.ones((a.kv_lora_rank,), device=device,
                                        dtype=dtype)},
        "wkv_b": dense(a.kv_lora_rank, H * (a.qk_nope_dim + a.v_head_dim)),
        "wo": dense(H * a.v_head_dim, cfg.d_model),
    }


def spec_gqa_cache():
    return {"k": ("data", None, "model", None),
            "v": ("data", None, "model", None),
            "pos": ("data", None)}


def spec_mla():
    return {"wq_a": ("fsdp", None), "q_norm": {"scale": (None,)},
            "wq_b": (None, "model"), "wkv_a": ("fsdp", None),
            "kv_norm": {"scale": (None,)}, "wkv_b": (None, "model"),
            "wo": ("model", "fsdp")}


def _mla_qkr(params, x, a: AttentionConfig, positions):
    """-> q_nope (B,S,H,dn), q_rope (B,S,H,dr) rotated, ckv (B,S,r)
    normalised, k_rope (B,S,dr) rotated (one shared rope key a position)."""
    B, S, _ = x.shape
    H = a.num_heads
    ql = apply_norm(params["q_norm"], x @ params["wq_a"], "rmsnorm")
    q = (ql @ params["wq_b"]).reshape(B, S, H, a.qk_nope_dim + a.qk_rope_dim)
    q_nope, q_rope = q[..., :a.qk_nope_dim], q[..., a.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, a.rope_theta)
    kv = x @ params["wkv_a"]
    ckv, k_rope = kv[..., :a.kv_lora_rank], kv[..., a.kv_lora_rank:]
    ckv = apply_norm(params["kv_norm"], ckv, "rmsnorm")
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        a.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def mla_forward(params, x, *, cfg: ModelConfig, lspec: LayerSpec, positions,
                mode: str = "train", cache=None, cache_max_len=None, **_):
    """Returns (y, new_cache), modes as ``gqa_forward`` (always causal).
    Decode writes the new latent, rope key and position into ``cache`` in
    place (each row at its own position) and attends in latent space: the
    key up-projection folded into the query, the value up-projection
    applied after the weighted sum."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mla_forward mode {mode!r}: train, prefill or "
                         "decode")
    a = cfg.attn
    B, S, _ = x.shape
    H = a.num_heads
    q_nope, q_rope, ckv, k_rope = _mla_qkr(params, x, a, positions)
    scale = 1.0 / math.sqrt(a.qk_nope_dim + a.qk_rope_dim)
    wkv_b = params["wkv_b"].reshape(a.kv_lora_rank, H,
                                    a.qk_nope_dim + a.v_head_dim)
    wk = wkv_b[..., :a.qk_nope_dim]  # (r, H, dn)
    wv = wkv_b[..., a.qk_nope_dim:]  # (r, H, dv)
    new_cache = None
    if mode == "decode":
        W = cache["ckv"].shape[1]
        idx = positions[:, 0].to(torch.int64)
        slots = torch.remainder(idx, W)
        rows = torch.arange(B, device=x.device)
        cc, cr, cpos = cache["ckv"], cache["krope"], cache["pos"]
        cc.index_put_((rows, slots), ckv[:, 0].to(cc.dtype))
        cr.index_put_((rows, slots), k_rope[:, 0].to(cr.dtype))
        cpos.index_put_((rows, slots), idx.to(cpos.dtype))
        bias = _mask_bias(positions, cpos, causal=True, window=lspec.window)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, wk)
        scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, cc)
                  + torch.einsum("bqhd,bsd->bhqs", q_rope, cr)
                  ).to(torch.float32)
        scores = scores * scale + bias[:, None, :, :]
        attn = torch.softmax(scores, dim=-1).to(cc.dtype)
        o_lat = torch.einsum("bhqs,bsr->bqhr", attn, cc)
        out = torch.einsum("bqhr,rhd->bqhd", o_lat, wv)
        new_cache = cache
    else:
        k_nope = torch.einsum("bsr,rhd->bshd", ckv, wk)
        v = torch.einsum("bsr,rhd->bshd", ckv, wv)
        k = torch.cat([k_nope, torch.broadcast_to(
            k_rope[:, :, None, :], (B, S, H, a.qk_rope_dim))], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        pos_b = torch.broadcast_to(positions, (B, S))
        bias = _mask_bias(pos_b, pos_b, causal=True, window=lspec.window)
        out = _sdpa(q, k, v, bias, scale)
        if mode == "prefill":
            pad = max(0, (cache_max_len or S) - S)
            F = torch.nn.functional
            new_cache = {"ckv": F.pad(ckv, (0, 0, 0, pad)),
                         "krope": F.pad(k_rope, (0, 0, 0, pad)),
                         "pos": F.pad(pos_b.to(torch.int32), (0, pad),
                                      value=-1)}
    y = out.reshape(B, S, H * a.v_head_dim) @ params["wo"]
    return y, new_cache


def init_mla_cache(cfg: ModelConfig, lspec: LayerSpec, B: int, seq_len: int,
                   *, device, dtype=torch.float32):
    """An empty cache: ckv (B, seq_len, r) and krope (B, seq_len, dr) zeros,
    pos (B, seq_len) int32 -1."""
    a = cfg.attn
    return {"ckv": torch.zeros((B, seq_len, a.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((B, seq_len, a.qk_rope_dim), dtype=dtype,
                                 device=device),
            "pos": torch.full((B, seq_len), -1, dtype=torch.int32,
                              device=device)}


def spec_mla_cache():
    return {"ckv": ("data", None, None), "krope": ("data", None, None),
            "pos": ("data", None)}


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------


init_cross = init_gqa  # the same four projections: wq, wk, wv, wo
spec_cross = spec_gqa


def cross_kv(params, enc_out, *, cfg: ModelConfig):
    """The encoder output projected once to keys and values, cached across
    decode steps: {"k", "v" (B, Se, Kv, hd), "pos" (B, Se) int32}. The
    ``pos`` row (-1 = empty) keeps a cache row padded to a larger encoder
    capacity (the engine's slots hold ``max_len`` rows) masked there."""
    a = cfg.attn
    B, Se, _ = enc_out.shape
    k = (enc_out @ params["wk"]).reshape(B, Se, a.num_kv_heads, a.head_dim)
    v = (enc_out @ params["wv"]).reshape(B, Se, a.num_kv_heads, a.head_dim)
    pos = torch.broadcast_to(
        torch.arange(Se, dtype=torch.int32, device=enc_out.device), (B, Se))
    return {"k": k, "v": v, "pos": pos}


def cross_forward(params, x, kv, *, cfg: ModelConfig):
    """Full (non-causal) attention from the decoder states x (B, S, d) to
    the cached encoder keys and values, the slots at pos -1 under the
    NEG_INF bias; the plain ``_sdpa`` (as the reference: never the
    blockwise route)."""
    a = cfg.attn
    B, S, _ = x.shape
    Se = kv["k"].shape[1]
    q = (x @ params["wq"]).reshape(B, S, a.num_heads, a.head_dim)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=x.device)
    bias = torch.broadcast_to(
        torch.where(kv["pos"][:, None, :] >= 0, zero, neg), (B, S, Se))
    y = _sdpa(q, kv["k"], kv["v"], bias, 1.0 / math.sqrt(a.head_dim))
    return y.reshape(B, S, a.q_dim) @ params["wo"]
