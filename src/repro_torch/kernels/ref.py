"""Plain PyTorch versions of the port's CUDA kernels.

They are what the kernel wrappers run for tensors on the CPU, and the
yardstick the kernels are held against on the card. Each repeats its
kernel's arithmetic in the same order, so on the card the mix, the wire
kernels (quantize, dequantize, sparsify) and the reduce's column mean agree
with their kernels bit for bit; only the reduce's sum of squares is summed
in another order.

The wire functions are the counterparts of the reference's oracles
(``src/repro/kernels/ref.py``): the per-row int8 scale and the grouped int4
scales (one per row per ``group`` columns), quantize with round to nearest
(ties to even, as ``jnp.round``) or stochastic rounding ``floor(x / scale +
u)`` (with the uniforms supplied, or drawn by Philox4x32-10 as the
on-chip-seeded quantize draws them: the generator in int64 arithmetic, bit for
bit with the kernel's), dequantize, the int4 nibble pack and unpack, and the
top-k threshold and mask. The scales and the threshold are row passes computed
outside the kernels, as in the reference.

The residency functions are the counterparts of the storages' oracles:
the grouped int8 scales (amax / 127), quantize and dequantize, the
signed-sqrt companding and the fused AdamW step on grouped-int8 moments
(decode, ``optim.adamw_core``, re-encode), each bit for bit with its kernel
on the card.

The merge functions are the counterparts of the merge operators' oracles:
the weighted column merge, the TIES trim thresholds (``jnp.quantile``'s
float32 arithmetic, outside the kernel as in the reference) and the TIES
column merge. The two column merges agree with their kernels bit for bit.

The attention functions are the counterparts of the reference's
``attention_ref`` (materialised scores) and of the online-softmax loop of
``models/attention.py:_sdpa_blockwise``, which the flash attention kernels
compute; torch autograd through that loop is the plain version of their
backward pass. They agree with the kernels to float32 tolerance (other
summation orders), not bit for bit.
"""
from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
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


def row_amax(x):
    """(m, 1) float32 max |x| of each row of an (m, D) panel, without an
    (m, D) temporary of |x|."""
    return torch.linalg.vector_norm(x.to(torch.float32), ord=float("inf"),
                                    dim=1, keepdim=True)


def amax_scale(amax, qmax: float = 127.0):
    """The symmetric scale amax / qmax of a float32 amax tensor; an amax of
    0 gets 1 / qmax, so dequantizing stays a plain multiply."""
    return div_exact(torch.where(amax > 0, amax, torch.ones_like(amax)),
                     qmax)


def int8_scale_ref(x):
    """Per-row symmetric int8 scale of an (m, D) panel: amax / 127 as
    (m, 1) float32; an all-zero row gets scale 1/127, so dequantizing stays
    a plain multiply."""
    return amax_scale(row_amax(x))


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


# Philox4x32-10 (Salmon et al., SC'11; Random123's and the CUDA toolkit's
# constants): the multipliers, the key increments (Weyl sequence)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF
NATIVE_BLOCK = 512  # columns per key word of the in-kernel draws


def _mulhilo32(a, b: int):
    """(high, low) 32-bit halves of a * b for int64 tensors ``a`` holding
    uint32 values and a uint32 constant ``b``, without overflowing int64
    (b split into 16-bit halves: each partial product is under 2^48)."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    low = p0 + ((p1 & 0xFFFF) << 16)
    return ((p1 >> 16) + (low >> 32)) & _U32, low & _U32


def philox4x32_ref(key, counter):
    """Philox4x32-10 in int64 arithmetic: ``key`` two uint32 words and
    ``counter`` four (int64 tensors or ints, broadcast together) -> the
    four uint32 output words as int64 tensors."""
    dev = next((w.device for w in (*key, *counter) if torch.is_tensor(w)),
               None)
    c = [torch.as_tensor(w, dtype=torch.int64, device=dev)
         for w in (*counter, *key)]
    c = list(torch.broadcast_tensors(*c))
    k0, k1 = c[4], c[5]
    c = c[:4]
    for i in range(10):
        if i:
            k0 = (k0 + PHILOX_W[0]) & _U32
            k1 = (k1 + PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo32(c[0], PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c[2], PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def native_uniforms_ref(seed, m: int, D: int, lo: int = 0, hi=None,
                        device=None, row0: int = 0):
    """The uniforms ``quantize_int8_native`` draws for columns [lo, hi) of
    an (m, D) panel (``lo`` a multiple of 4): column c of row r is word
    c % 4 of Philox4x32-10 on key (seed, c // 512) and counter (r,
    (c % 512) // 4, 0, 0), its low 24 bits times 2^-24. ``seed`` is an
    int or a 1-element int32 tensor (its bits as a uint32). ``row0`` is
    the panel row of the first of the m rows (a row shard of a wider
    panel); the columns are the panel's own."""
    hi = D if hi is None else hi
    seed = int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)
    q = torch.arange(lo // 4, (hi + 3) // 4, dtype=torch.int64,
                     device=device)
    rows = torch.arange(row0, row0 + m, dtype=torch.int64,
                        device=device)[:, None]
    quads_per_block = NATIVE_BLOCK // 4
    words = philox4x32_ref(
        (seed & _U32, (q // quads_per_block)[None]),
        (rows, (q % quads_per_block)[None], 0, 0))
    bits = torch.stack(words, dim=-1).reshape(m, -1)[:, :hi - lo]
    return (bits & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def quantize_int8_native_ref(x, scale, seed, chunk: int = 1 << 21,
                             row0: int = 0, col0: int = 0):
    """The plain version of ``quantize_int8_native``: quantize_int8_ref
    with stochastic rounding against :func:`native_uniforms_ref`'s draws,
    a column chunk at a time (``chunk`` a multiple of 512). ``x`` may be
    the block of a wider panel whose first row is ``row0`` and first
    column ``col0`` (a multiple of 512): it draws that block's uniforms."""
    m, D = x.shape
    q = torch.empty((m, D), dtype=torch.int8, device=x.device)
    for lo in range(0, D, chunk):
        hi = min(lo + chunk, D)
        u = native_uniforms_ref(seed, m, col0 + D, col0 + lo, col0 + hi,
                                device=x.device, row0=row0)
        q[:, lo:hi] = quantize_int8_ref(x[:, lo:hi], scale, u)
        del u
    return q


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


def _group_scale(x, group: int, qmax: float):
    """amax / qmax per row per ``group``-column block of an (m, D) panel ->
    (m, ceil(D / group)) float32; a partial tail group reduces over its real
    columns only, an all-zero group gets 1 / qmax."""
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
    return div_exact(torch.where(a > 0, a, torch.ones_like(a)), qmax)


def int4_group_scale_ref(x, group: int = 128):
    """Grouped symmetric int4 scales of an (m, D) panel: amax / 7 per row
    per ``group``-column block -> (m, ceil(D / group)) float32. A partial
    tail group reduces over its real columns only; an all-zero group gets
    scale 1/7, so dequantizing stays a plain multiply."""
    return _group_scale(x, group, 7.0)


def int8_group_scale_ref(x, group: int = 128):
    """Grouped symmetric int8 scales (the residency storages' layout):
    amax / 127 per row per ``group``-column block -> (m, ceil(D / group))
    float32, the tail group over its real columns, an all-zero group 1/127.
    """
    return _group_scale(x, group, 127.0)


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


def quantize_int8_grouped_ref(x, scale, u=None, group: int = 128):
    """x: (m, D); scale: (m, ceil(D / group)) float32 -> int8 (m, D) in
    [-127, 127]: floor(x / s + u) with ``u`` (uniform in [0, 1), the shape
    of x), else x / s rounded to nearest (ties to even); s the scale of the
    column's group, true IEEE division."""
    s = x.to(torch.float32) / expand_group_scale(scale, x.shape[1], group)
    q = torch.floor(s.add_(u)) if u is not None else torch.round(s)
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def dequantize_int8_grouped_ref(q, scale, group: int = 128):
    """q: (m, D) int8; scale: (m, ceil(D / group)) float32 -> float32
    (m, D) q * s, s the scale of the column's group."""
    return q.to(torch.float32) * expand_group_scale(scale, q.shape[1], group)


def signed_sqrt(x):
    """The companding of the int8 moment storages: sign(x) * sqrt(|x|),
    with the correctly rounded float32 square root on every device (the
    float64 root rounded once; PyTorch's float32 square root on the CPU
    lands an ulp off for some inputs, the kernel's ``__fsqrt_rn`` and
    XLA's do not)."""
    x = x.to(torch.float32)
    r = torch.sqrt(torch.abs(x).to(torch.float64)).to(torch.float32)
    return torch.sign(x) * r


def signed_square(y):
    """The inverse companding: sign(y) * y^2."""
    return torch.sign(y) * torch.square(y)


def adamw_fused_int8_ref(g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2, *,
                         group: int = 128, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8,
                         weight_decay: float = 0.0, transform=None):
    """One AdamW step on grouped-int8 moments, decode -> update -> encode.

    g, p: (m, D) float32; qm, qv: (m, D) int8; sm, sv: (m, ceil(D / group))
    float32 scales; um, uv: (m, D) uniforms in [0, 1) for the stochastic
    re-encode; lr, bc1, bc2: (m, 1) float32 per-agent columns; ``transform``
    None (linear) or "sqrt" (signed-sqrt companding). Decodes both moments
    (dequantize, then the inverse transform), runs ``optim.adamw_core``
    with these constants, then takes the forward transform of the new
    moments, their fresh grouped scales (amax / 127, an all-zero group
    1/127) and the stochastic re-encode floor(z / s + u). Returns new
    tensors (p, qm, sm, qv, sv): by construction the unfused composition
    of the storages' read, the optimizer and write."""
    from repro_torch.optim.optim import adamw_core
    fwd = signed_sqrt if transform == "sqrt" else (lambda x: x)
    inv = signed_square if transform == "sqrt" else (lambda y: y)
    m = inv(dequantize_int8_grouped_ref(qm, sm, group))
    v = inv(dequantize_int8_grouped_ref(qv, sv, group))
    p, m, v = adamw_core(g, m, v, p, lr=lr, bc1=bc1, bc2=bc2, b1=b1, b2=b2,
                         eps=eps, weight_decay=weight_decay)
    out = [p]
    for x, u in ((m, um), (v, uv)):
        z = fwd(x)
        s = int8_group_scale_ref(z, group)
        out += [quantize_int8_grouped_ref(z, s, u, group), s]
    return tuple(out)


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


def weighted_colmerge_ref(x, w):
    """x: (m, D) float32 panel; w: (m, D) float32 per-coordinate weights ->
    (D,) float32 sum_k w_kj x_kj / sum_k w_kj.

    Fixed order over k from k = 0, a row at a time: num = w_0 x_0, then
    num + w_k x_k with the product and the sum rounded on their own (no
    fused multiply-add), den = w_0 + w_1 + ..., and one IEEE division at
    the end — the kernel's sequence. Callers keep the denominator positive
    by folding their eps into w."""
    num = w[0] * x[0]
    den = w[0].clone()
    for k in range(1, x.shape[0]):
        num.add_(w[k] * x[k])
        den.add_(w[k])
    return num.div_(den)


def _fma32(a, b, c):
    """float32 fused multiply-add: a * b + c rounded once to float32 (to
    nearest, ties to even), computed exactly with rationals."""
    if not all(np.isfinite(v) for v in (a, b, c)):
        return np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))  # within an ulp of the answer
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.uint32)) & 1))


def _order_stats(v, lo: int, hi: int):
    """The lo-th and hi-th smallest entries (0-based) of the 1-D tensor v,
    exactly, as float32 numpy scalars: ``torch.kthvalue`` on the CPU (a
    selection), one sort on the card, whose ``kthvalue`` selects with a
    single thread block per row (one row at olmo-1b's width, on an H100
    80GB HBM3 at 700 W: kthvalue 1.733 s, sort 0.012 s; chip_smoke.py
    times both)."""
    if v.device.type == "cpu":
        low = torch.kthvalue(v, lo + 1).values.item()
        high = low if hi == lo else torch.kthvalue(v, hi + 1).values.item()
    else:
        srt = torch.sort(v).values
        low, high = srt[lo].item(), srt[hi].item()
    return np.float32(low), np.float32(high)


def ties_index(D: int, trim: float):
    """(lo index, hi index, low weight, high weight) of the ``1 - trim``
    quantile of D values, in jnp.quantile's float32 arithmetic (see
    :func:`ties_thresh_ref`)."""
    if not 0.0 < trim <= 1.0:
        raise ValueError(f"trim fraction must be in (0, 1], got {trim}")
    one = np.float32(1.0)
    q = np.float32(1.0 - trim)
    n = np.float32(D)
    pos = q * (n - one)
    lo, hi = np.floor(pos), np.ceil(pos)
    hw = pos - lo
    lw = one - hw
    top = n - one
    lo_i = min(int(np.clip(lo, 0, top)), D - 1)
    hi_i = min(int(np.clip(hi, 0, top)), D - 1)
    return lo_i, hi_i, lw, hw


def ties_thresh_ref(tau, trim: float):
    """Per-row magnitude threshold of the TIES trim: the ``1 - trim``
    quantile of |tau| in each row, as ``jnp.quantile(|tau|, 1 - trim,
    axis=1, keepdims=True)`` computes it (method 'linear'): q =
    float32(1 - trim), n = float32(D), the index q * (n - 1), its floor and
    ceil and both interpolation weights all in float32, the two order
    statistics picked exactly, one row at a time (the index clamped to
    D - 1 as XLA's gather clamps it; :func:`_order_stats`), and the
    interpolation low * lw + high * hw as XLA on the CPU compiles it under
    jit (JAX 0.9.0): high * hw rounded to float32, then one fused
    multiply-add fma(low, lw, .) (held against jitted ``jnp.quantile`` bit
    for bit by the tests; both products rounded on their own would differ
    by an ulp in about one row in six). A row
    holding a NaN gives NaN. tau: (m, D) -> (m, 1) float32 on tau's
    device.

    ``torch.quantile`` is not used: it refuses more than 2^24 elements and
    does its own index arithmetic. Nor is the index taken in float64: at
    D = 237,502,464 and trim 0.2 the float32 index is 190,001,968 with
    weight 0, the exact one 190,001,970.4."""
    m, D = tau.shape
    lo_i, hi_i, lw, hw = ties_index(D, trim)
    out = np.empty((m, 1), dtype=np.float32)
    for r in range(m):
        mag = torch.abs(tau[r].to(torch.float32))
        if bool(torch.isnan(mag).any()):
            out[r, 0] = np.nan
            continue
        low, high = _order_stats(mag, lo_i, hi_i)
        del mag
        out[r, 0] = _fma32(low, lw, high * hw)
    return torch.from_numpy(out).to(tau.device)


def _ties_trimmed(t, th):
    """One row of deviations with the entries below the row's threshold
    set to +0."""
    return torch.where(torch.abs(t) >= th, t,
                       torch.zeros((), dtype=t.dtype, device=t.device))


def ties_colmerge_ref(tau, thresh):
    """TIES column merge: tau (m, D) float32 deviations; thresh (m, 1)
    float32 per-row thresholds (ties_thresh_ref) -> (D,) float32.

    Per column, in the reference's order (``kernels/merge_ops.py`` of the
    reference): entries below their row's threshold are trimmed to 0, the
    trimmed column is summed over k in fixed order, its sign elected (a
    sum of 0 elects +), and only the surviving entries that agree with the
    sign are averaged: count and sum in fixed order over k from 0, then
    sum / max(count, 1) in IEEE division, 0 where nothing survives. A row
    at a time; the trimmed row is formed again for the second pass rather
    than kept (the kernel keeps it in registers)."""
    m = tau.shape[0]
    col = _ties_trimmed(tau[0], thresh[0])
    for k in range(1, m):
        col.add_(_ties_trimmed(tau[k], thresh[k]))
    up = col >= 0
    del col
    cnt = torch.zeros_like(tau[0])
    dev = torch.zeros_like(tau[0])
    zero = torch.zeros((), dtype=tau.dtype, device=tau.device)
    for k in range(m):
        tk = _ties_trimmed(tau[k], thresh[k])
        agree = torch.where(up, tk > 0, tk < 0)
        cnt.add_(agree.to(torch.float32))
        dev.add_(torch.where(agree, tk, zero))
    return torch.where(cnt > 0, dev.div_(torch.clamp_min(cnt, 1.0)), zero)


NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window=None, scale=None):
    """q, k, v: (B, S, H, hd), the same H (GQA expanded by the caller) ->
    (B, S, H, hd). Float32 scores, masked by a NEG_INF fill (causal and/or
    keep k > q - window), softmax, cast to v's type, then the second
    product."""
    B, S, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    scores = scores.masked_fill(~ok, NEG_INF)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _online_softmax(q, k, v, q_pos, k_pos, *, causal, window, scale, block):
    """The loop of ``_sdpa_blockwise``: -> (acc, m, l), float32, with
    acc (B, Kv, G, Sq, dv) and m, l (B, Kv, G, Sq)."""
    B, Sq, H, dq = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // Kv
    block = min(block, Sk)
    pad = (-Sk) % block
    if pad:  # the key tail: zero keys at position -1, never visible
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    qr = q.reshape(B, Sq, Kv, G, dq)
    qp = q_pos[:, None, None, :, None]
    m = torch.full((B, Kv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Kv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Kv, G, Sq, dv), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, Sk + pad, block):
        kb, vb = k[:, lo:lo + block], v[:, lo:lo + block]
        kp = k_pos[:, lo:lo + block][:, None, None, None, :]
        s = torch.einsum("bqkgd,bskd->bkgqs", qr, kb).to(torch.float32)
        s = s * scale
        ok = kp >= 0
        if causal:
            ok = ok & (kp <= qp)
        if window is not None:
            ok = ok & (kp > qp - window)
        s = s.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1)
        acc = (acc * alpha[..., None]
               + torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype),
                              vb).to(torch.float32))
        m = m_new
    return acc, m, l


def flash_attention_ref(q, k, v, q_pos, k_pos, *, causal: bool = True,
                        window=None, scale=None, block: int = 64):
    """Blockwise online-softmax attention, the twin of the reference's
    ``_sdpa_blockwise`` and the function the flash attention kernels
    compute. q: (B, Sq, H, dq); k: (B, Sk, Kv, dq); v: (B, Sk, Kv, dv) with
    H % Kv == 0 (query head h reads key/value head h // (H / Kv));
    q_pos (B, Sq), k_pos (B, Sk) integer positions (k_pos < 0: no key).
    Keys are taken ``block`` at a time, the tail padded at position -1;
    masked scores are a NEG_INF fill; the running max, l and acc stay
    float32, p is cast to v's type before its product, and the output is
    acc / max(l, 1e-30) in v's type. Returns (B, Sq, H, dv)."""
    return flash_attention_fwd_ref(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, scale=scale,
                                   block=block)[0]


def flash_attention_fwd_ref(q, k, v, q_pos, k_pos, *, causal: bool = True,
                            window=None, scale=None, block: int = 64):
    """The forward kernel's outputs: (``flash_attention_ref``'s output,
    the float32 log-sum-exp m + log(l) per (B, H, Sq) row)."""
    B, Sq, H, _ = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    acc, m, l = _online_softmax(q, k, v, q_pos, k_pos, causal=causal,
                                window=window, scale=scale, block=block)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(v.dtype)
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1]),
            (m + torch.log(l)).reshape(B, H, Sq))


def flash_attention_bwd_ref(q, k, v, dout, q_pos, k_pos, *,
                            causal: bool = True, window=None, scale=None,
                            block: int = 64):
    """The backward kernels' outputs: (dq, dk, dv), torch autograd through
    ``flash_attention_ref`` with cotangent ``dout``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, q_pos, k_pos, causal=causal,
                                  window=window, scale=scale, block=block)
        return torch.autograd.grad(out, leaves, dout)
