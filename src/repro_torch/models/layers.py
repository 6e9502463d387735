"""Dense building blocks as plain functions on tensors.

Counterparts of ``repro/models/layers.py`` for the dense family: the same
parameter key names and layouts (weights stored (d_in, d_out), applied as
``x @ w``), the same float32 arithmetic. Each ``init_*`` has the
reference's ``spec_*``: the tree of logical axis names of its leaves
(plain tuples, ``models/sharding.py`` resolves them). The reference's
sharding constraints on activations have no counterpart; on the split
route (``models/tensor_parallel.py``) :func:`apply_mlp` and
:func:`chunked_softmax_xent` take a ``split`` and run on the rank's
d_ff columns and vocabulary.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(generator, d_in, d_out, *, device, dtype=torch.float32,
               scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(norm_kind: str, d: int, *, device, dtype=torch.float32):
    if norm_kind == "rmsnorm":
        return {"scale": torch.ones((d,), device=device, dtype=dtype)}
    if norm_kind == "layernorm":
        return {"scale": torch.ones((d,), device=device, dtype=dtype),
                "bias": torch.zeros((d,), device=device, dtype=dtype)}
    if norm_kind == "nonparam_ln":
        return {}
    raise ValueError(norm_kind)


def spec_norm(norm_kind: str):
    if norm_kind == "rmsnorm":
        return {"scale": (None,)}
    if norm_kind == "layernorm":
        return {"scale": (None,), "bias": (None,)}
    return {}


def apply_norm(params, x, norm_kind: str, eps=1e-6):
    """Computed in float32; eps sits inside the rsqrt."""
    dt = x.dtype
    x = x.to(torch.float32)
    if norm_kind == "rmsnorm":
        x = x * torch.rsqrt(torch.mean(torch.square(x), -1, keepdim=True)
                            + eps)
        x = x * params["scale"].to(torch.float32)
    else:
        mu = torch.mean(x, -1, keepdim=True)
        var = torch.mean(torch.square(x - mu), -1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
        if norm_kind == "layernorm":
            x = (x * params["scale"].to(torch.float32)
                 + params["bias"].to(torch.float32))
    return x.to(dt)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def activation(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x, positions, theta=10000.0):
    """x: (..., S, H, hd); positions broadcastable to (..., S). Half-split
    rotation: the first and second halves of hd form the pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]  # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, sections, theta=1000000.0):
    """Multimodal RoPE (Qwen2-VL). x: (B, S, H, hd); positions3: (3, B, S)
    temporal / height / width position ids; ``sections`` splits the hd/2
    frequencies into (t, h, w) groups: frequency i rotates by the position
    of row ``sec[i]`` of positions3. The half-split rotation of
    ``apply_rope``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])  # (hd/2,)
    pos = torch.movedim(positions3[sec], 0, -1)  # (B, S, hd/2)
    angles = (pos.to(torch.float32) * freqs)[..., None, :]  # (B, S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(generator, d, d_ff, *, device, gated=True, dtype=torch.float32):
    # draw order follows the reference's key split: w_in, w_out, w_gate
    p = {"w_in": dense_init(generator, d, d_ff, device=device, dtype=dtype),
         "w_out": dense_init(generator, d_ff, d, device=device, dtype=dtype)}
    if gated:
        p["w_gate"] = dense_init(generator, d, d_ff, device=device,
                                 dtype=dtype)
    return p


def spec_mlp(gated=True):
    p = {"w_in": ("fsdp", "model"), "w_out": ("model", "fsdp")}
    if gated:
        p["w_gate"] = ("fsdp", "model")
    return p


def apply_mlp(params, x, act_fn, gated=True, split=None):
    """``act(x @ w_gate) * (x @ w_in) @ w_out`` (ungated: act(x @ w_in)).
    With ``split`` (``tensor_parallel.Split``) the leaves are the rank's
    blocks: ``w_in``/``w_gate`` its d_ff columns, ``w_out`` its rows; x
    enters through ``split.copy_in`` and the output leaves through
    ``split.reduce_out`` (one all-reduce over the model line)."""
    if split is not None:
        x = split.copy_in(x)
    h = x @ params["w_in"]
    if gated:
        h = act_fn(x @ params["w_gate"]) * h
    else:
        h = act_fn(h)
    y = h @ params["w_out"]
    return y if split is None else split.reduce_out(y)


# ---------------------------------------------------------------------------
# embeddings + chunked cross-entropy
# ---------------------------------------------------------------------------


def init_embed(generator, vocab, d, *, device, dtype=torch.float32):
    t = torch.randn((vocab, d), generator=generator, device=device,
                    dtype=torch.float32)
    return {"table": (t * (1.0 / math.sqrt(d))).to(dtype)}


def spec_embed():
    return {"table": ("fsdp", "model")}


def embed_tokens(params, tokens, scale=False):
    x = params["table"][tokens.long()]
    if scale:
        x = x * math.sqrt(params["table"].shape[-1])
    return x


def chunked_softmax_xent(h, head_w, targets, mask, chunk: int, split=None):
    """Cross-entropy over the full (padded) head, ``chunk`` positions of S
    at a time. h: (B, S, d); head_w: (d, V); targets: (B, S) int; mask:
    (B, S) {0,1}. Returns (sum_nll, sum_mask), both float32 scalars.

    With ``split`` the head is vocab-parallel: ``head_w`` is the rank's
    (d, V / M) columns, the vocabulary's rows [j V / M, (j + 1) V / M),
    and each chunk's logsumexp and target logit are taken over the model
    line (``split.vocab_nll``); h must have entered through
    ``split.copy_in``."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, S, chunk):
        hc, tc, mc = h[:, lo:lo + chunk], targets[:, lo:lo + chunk], \
            mask[:, lo:lo + chunk]
        lg = (hc @ head_w).to(torch.float32)  # (B, c, V)
        if split is not None:
            total = total + torch.sum(split.vocab_nll(lg, tc) * mc)
            continue
        lse = torch.logsumexp(lg, dim=-1)
        tgt = torch.gather(lg, -1, tc.long()[..., None])[..., 0]
        total = total + torch.sum((lse - tgt) * mc)
    return total, torch.sum(mask.to(torch.float32))
