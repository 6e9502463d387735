"""Plain PyTorch versions of the port's CUDA kernels.

They are what the kernel wrappers run for tensors on the CPU, and the
yardstick the kernels are held against on the card. Each repeats its
kernel's arithmetic in the same order, so on the card the mix, the wire
kernels (quantize, dequantize, sparsify) and the reduce's column mean agree
with their kernels bit for bit; only the reduce's sum of squares is summed
in another order.

The wire functions are the counterparts of the reference's oracles
(``src/repro/kernels/ref.py``): the per-row int8 scale, quantize with
round to nearest (ties to even, as ``jnp.round``) or stochastic rounding
``floor(x / scale + u)``, dequantize, and the top-k threshold and mask.
The scale and the threshold are full row passes computed outside the
kernels, as in the reference.
"""
from __future__ import annotations

import torch


def gossip_mix_ref(W, theta):
    """W: (n, m); theta: (m, D) -> W @ theta, float32 accumulation.

    A fixed-order sum over k: acc = W[:, 0] * theta[0], then
    acc = acc + W[:, k] * theta[k] for k = 1 .. m-1, each product and each
    sum rounded on its own (no fused multiply-add) — the order the CUDA
    kernel uses, so every output row that has the same weights comes out
    the same bit for bit."""
    w = W.to(torch.float32)
    t = theta.to(torch.float32)
    acc = w[:, 0:1] * t[0:1]
    for k in range(1, t.shape[0]):
        acc.add_(w[:, k:k + 1] * t[k:k + 1])
    return acc.to(theta.dtype)


def panel_mean_consensus_ref(theta):
    """theta: (m, D) -> (column mean (D,) f32, total squared deviation
    sum_{k,j} (theta_kj - mean_j)^2 as a float32 scalar tensor).

    The column sum runs over k in order and is divided by m, as in the
    kernel. Each deviation is rounded to float32, then squared and summed
    in float64 one row at a time, and the total is rounded once to float32
    (the kernel also squares and accumulates in float64)."""
    t = theta.to(torch.float32)
    acc = t[0].clone()
    for k in range(1, t.shape[0]):
        acc.add_(t[k])
    mean = acc / t.shape[0]
    sq = torch.zeros((), dtype=torch.float64, device=t.device)
    for k in range(t.shape[0]):
        sq += torch.sum(torch.square((t[k] - mean).to(torch.float64)))
    return mean, sq.to(torch.float32)


def int8_scale_ref(x):
    """Per-row symmetric int8 scale of an (m, D) panel: amax / 127 as
    (m, 1) float32; an all-zero row gets scale 1/127, so dequantizing stays
    a plain multiply."""
    # the row max of |x| without an (m, D) temporary of |x|
    amax = torch.linalg.vector_norm(x.to(torch.float32), ord=float("inf"),
                                    dim=1, keepdim=True)
    return torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0


def quantize_int8_ref(x, scale, u=None):
    """x: (m, D); scale: (m, 1) float32 -> int8 (m, D) in [-127, 127].

    ``u`` (uniform in [0, 1), the shape of x) selects stochastic rounding
    floor(x / scale + u); ``u=None`` rounds to nearest, ties to even. The
    division is IEEE float32 division (never a reciprocal multiply): one
    ulp in x / scale can flip a rounding decision."""
    s = x.to(torch.float32) / scale
    q = torch.floor(s + u) if u is not None else torch.round(s)
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def dequantize_int8_ref(q, scale):
    """q: (m, D) int8; scale: (m, 1) float32 -> float32 panel q * scale."""
    return q.to(torch.float32) * scale


def topk_threshold_ref(x, k: int):
    """The k-th largest |x| of each row: (m, D) -> contiguous (m, 1)
    float32 (the kernel reads one value per row)."""
    mag = torch.abs(x.to(torch.float32))
    return torch.topk(mag, k, dim=1).values[:, -1:].contiguous()


def sparsify_topk_ref(x, thresh):
    """Zero every entry whose magnitude is below its row's threshold.
    x: (m, D); thresh: (m, 1) float32 -> float32 panel. Ties at the
    threshold survive."""
    x32 = x.to(torch.float32)
    return torch.where(torch.abs(x32) >= thresh, x32,
                       torch.zeros((), dtype=torch.float32, device=x.device))
