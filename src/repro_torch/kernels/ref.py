"""Plain PyTorch versions of the port's CUDA kernels.

They are what the kernel wrappers run for tensors on the CPU, and the
yardstick the kernels are held against on the card. Each repeats its
kernel's arithmetic in the same order, so on the card the mix, the wire
kernels (quantize, dequantize, sparsify) and the reduce's column mean agree
with their kernels bit for bit; only the reduce's sum of squares is summed
in another order.

The wire functions are the counterparts of the reference's oracles
(``src/repro/kernels/ref.py``): the per-row int8 scale and the grouped
int4 scales (one per row per ``group`` columns), quantize with round to
nearest (ties to even, as ``jnp.round``) or stochastic rounding
``floor(x / scale + u)``, dequantize, the int4 nibble pack and unpack, and
the top-k threshold and mask. The scales and the threshold are row passes
computed outside the kernels, as in the reference.
"""
from __future__ import annotations

import torch


def gossip_mix_ref(W, theta):
    """W: (n, m); theta: (m, D) float32 or bfloat16 -> W @ theta as float32
    (a bfloat16 theta is upcast exactly; the output stays float32, the
    folded mean row included).

    A fixed-order sum over k: acc = W[:, 0] * theta[0], then
    acc = acc + W[:, k] * theta[k] for k = 1 .. m-1, each product and each
    sum rounded on its own (no fused multiply-add) — the order the CUDA
    kernel uses, so every output row that has the same weights comes out
    the same bit for bit."""
    w = W.to(torch.float32)
    acc = w[:, 0:1] * theta[0:1].to(torch.float32)
    for k in range(1, theta.shape[0]):
        acc.add_(w[:, k:k + 1] * theta[k:k + 1].to(torch.float32))
    return acc


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
    return div_exact(torch.where(amax > 0, amax, torch.ones_like(amax)),
                     127.0)


def div_exact(a, d: float):
    """a / d in IEEE float32 division on every device: PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal
    (an ulp away from a / d), so the divisor is a tensor on a's device."""
    return a / torch.tensor(d, dtype=torch.float32, device=a.device)


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


def int4_group_scale_ref(x, group: int = 128):
    """Grouped symmetric int4 scales of an (m, D) panel: amax / 7 per row
    per ``group``-column block -> (m, ceil(D / group)) float32. A partial
    tail group reduces over its real columns only; an all-zero group gets
    scale 1/7, so dequantizing stays a plain multiply."""
    x32 = x.to(torch.float32)
    m, D = x32.shape
    full = D // group * group

    def amax(v, dim):  # max |v| without a temporary of |v|
        return torch.linalg.vector_norm(v, ord=float("inf"), dim=dim)

    parts = []
    if full:
        parts.append(amax(x32[:, :full].reshape(m, full // group, group), 2))
    if full < D:
        parts.append(amax(x32[:, full:], 1)[:, None])
    a = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return div_exact(torch.where(a > 0, a, torch.ones_like(a)), 7.0)


def expand_group_scale(scale, D: int, group: int = 128):
    """(m, ceil(D / group)) grouped scales -> (m, D): each scale repeated
    over its column group, the tail group cut to the real width."""
    return torch.repeat_interleave(scale, group, dim=1)[:, :D]


def quantize_int4_ref(x, scale, u=None, group: int = 128):
    """x: (m, D); scale: (m, ceil(D / group)) float32 -> int8 (m, D) in
    [-7, 7] (the int4 values before nibble packing). ``u`` (uniform in
    [0, 1), the shape of x) selects stochastic rounding floor(x / s + u);
    ``u=None`` rounds to nearest, ties to even. True IEEE division."""
    s = x.to(torch.float32) / expand_group_scale(scale, x.shape[1], group)
    q = torch.floor(s.add_(u)) if u is not None else torch.round(s)
    return torch.clamp(q, -7.0, 7.0).to(torch.int8)


def dequantize_int4_ref(q, scale, group: int = 128):
    """q: (m, D) int4-valued int8; scale: (m, ceil(D / group)) float32 ->
    float32 (m, D) q * s."""
    return q.to(torch.float32) * expand_group_scale(scale, q.shape[1], group)


def pack_int4_ref(q):
    """(m, D) int4-valued int8 -> (m, ceil(D / 2)) uint8: two values per
    byte, the even column in the LOW nibble, the odd column in the high
    one, row by row; an odd tail packs against a zero nibble. This is the
    wire's byte layout."""
    m, D = q.shape
    if D % 2:
        q = torch.cat([q, torch.zeros((m, 1), dtype=q.dtype,
                                      device=q.device)], dim=1)
    n = q.view(torch.uint8) & 0xF
    return n[:, 0::2] | (n[:, 1::2] << 4)


def unpack_int4_ref(p, D: int):
    """(m, ceil(D / 2)) uint8 -> (m, D) int8, each nibble sign-extended
    with (n ^ 8) - 8. The exact inverse of pack_int4_ref on [-8, 7]."""
    m = p.shape[0]
    nib = torch.stack([p & 0xF, p >> 4], dim=2).reshape(m, -1)[:, :D]
    return ((nib.to(torch.int8) ^ 8) - 8).to(torch.int8)
