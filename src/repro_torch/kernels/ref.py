"""Plain PyTorch versions of the port's CUDA kernels.

They are what the kernel wrappers run for tensors on the CPU, and the
yardstick the kernels are held against on the card. Each repeats its
kernel's arithmetic in the same order, so on the card the mix agrees with
its kernel bit for bit and the reduce's column mean does too; only the
reduce's sum of squares is summed in another order.
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
