"""The flash attention kernels' premises, checked on the CPU.

The kernels (``src/repro_torch/kernels/csrc/flash_attention.cu``) run every
float32 product on the tensor cores in split TF32: each operand x becomes
hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna``: 10 mantissa bits, round to
nearest, ties away), and a b becomes hi_a hi_b + hi_a lo_b + lo_a hi_b.
Here those products are emulated in plain torch (TF32 rounding on the int32
view; every product of two TF32 values is exact in float32, so a float32
matmul of the parts sums exact products) and pushed through the forward
formulas (the online softmax over 64-key tiles) and the backward formulas
at hd 128, S 1024: causal, causal with a window of 100, and GQA (4 query
heads on 2 key/value heads). The results must stay within the card tests'
tolerances of float64 (output and log-sum-exp 2e-5, gradients 1e-4). A
control shows the test has teeth: one-pass TF32 (hi_a hi_b alone) misses
2e-5. The emulation sums in float32 with rounding to nearest; the tensor
cores' own accumulation truncates, which the kernels bound by short chains
(a fresh accumulator a tile) and the card tests hold.

At hd 256 the kernels split each product's reduction over the two warps
of a pair (S, and dP in the backward, as two 128-column partial
products, added) and, for MQA, the backward's dK/dV over parts of the
query heads, whose partial sums a second kernel adds in ascending order:
those orders are emulated too, the forward's over its 32-key tiles, at
gemma-2b's 8 query heads on one and recurrentgemma-2b's 10 (S 1024,
causal and a window of 100), and the dK/dV grid's size and balance at the
cells' shapes is reckoned from the kernel's rule (``bwd_parts``).

Also here, on CPU tensors: the wrapper's rule for reading a tensor in place
(16-byte rows), and the resource query's refusal of a head dim that no
kernel takes.
"""
import math

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro_torch.kernels.flash_attention import (SMS, _rows, bwd_parts,
                                                 occupancy)

S, HD, TILE = 1024, 128, 64
WIDE = 256  # the head dim of the warp pairs (gemma-2b's)
FWD_KEYS = 32  # the forward kernels' key tile (kFwdKeys)
NEG_INF = -1e30


def tf32(x):
    """x (float32) rounded to TF32 as cvt.rna.tf32.f32 does (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_split(a, b):
    """a @ b in split TF32: hi hi + (hi lo + lo hi), float32 sums."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def mm_one_pass(a, b):
    """a @ b in one-pass TF32 (hi hi alone)."""
    return tf32(a) @ tf32(b)


def mm_exact(a, b):
    return a @ b


def _mask(window):
    i = torch.arange(S)
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok = ok & (i[None, :] > i[:, None] - window)
    return ok


def forward(q, k, v, window, mm):
    """(out, lse) of causal attention, q (H, S, hd), k, v (H, S, hd) (GQA
    already by index), the kernels' online softmax over 64-key tiles; every
    product through ``mm``, the rest in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    ok = _mask(window)
    H = q.shape[0]
    m = torch.full((H, S), NEG_INF, dtype=q.dtype)
    l = torch.zeros((H, S), dtype=q.dtype)
    acc = torch.zeros_like(q)
    for k0 in range(0, S, TILE):
        s = mm(q, k[:, k0:k0 + TILE].transpose(1, 2)) * scale
        s = s.masked_fill(~ok[:, k0:k0 + TILE], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + mm(p, v[:, k0:k0 + TILE])
        m = m_new
    return acc / l[..., None], m + torch.log(l)


def backward(q, k, v, out, lse, do, window, mm, G):
    """(dq, dk, dv) from the forward's out and lse, every product through
    ``mm``; dk and dv summed over the G query heads of each kv head."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (do * out).sum(-1)
    s = mm(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~_mask(window), 0.0)
    dp = mm(do, v.transpose(1, 2))
    ds = p * (dp - delta[..., None])
    dv = mm(p.transpose(1, 2), do)
    dk = scale * mm(ds.transpose(1, 2), q)
    dq = scale * mm(ds, k)
    H = q.shape[0]
    return (dq, dk.reshape(H // G, G, S, -1).sum(1),
            dv.reshape(H // G, G, S, -1).sum(1))


def _inputs(H, Kv, seed):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((H, S, HD)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((Kv, S, HD)).astype(
        np.float32)) for _ in range(2))
    return q, k, v, do


def _run(H, Kv, window, mm, seed=0):
    """((out, lse, dq, dk, dv) through ``mm`` in float32, the same in
    float64 with exact products)."""
    q, k, v, do = _inputs(H, Kv, seed)
    G = H // Kv
    got, want = [], []
    for dtype, f in ((torch.float32, mm), (torch.float64, mm_exact)):
        qq, kk, vv, dd = (t.to(dtype) for t in (q, k, v, do))
        kx, vx = kk.repeat_interleave(G, 0), vv.repeat_interleave(G, 0)
        out, lse = forward(qq, kx, vx, window, f)
        grads = backward(qq, kx, vx, out, lse, dd, window, f, G)
        (got if dtype == torch.float32 else want).append(
            (out, lse) + grads)
    return got[0], want[0]


CASES = [(1, 1, None), (1, 1, 100), (4, 2, None)]  # (H, Kv, window)


@pytest.mark.parametrize("H,Kv,window", CASES)
def test_split_tf32_forward_within_tolerance(H, Kv, window):
    got, want = _run(H, Kv, window, mm_split)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a.double(), b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("H,Kv,window", CASES)
def test_split_tf32_gradients_within_tolerance(H, Kv, window):
    got, want = _run(H, Kv, window, mm_split)
    for a, b in zip(got[2:], want[2:]):
        assert a.shape == b.shape
        torch.testing.assert_close(a.double(), b, atol=1e-4, rtol=1e-4)


def backward_pairs(q, k, v, out, lse, do, window, mm, parts):
    """(dq, dk, dv) of MQA (q, do (H, S, hd); k, v (1, S, hd)) in the
    hd-256 kernels' order of summation, every product through ``mm``: S
    and dP as columns 0-127's partial product plus columns 128-255's; dK
    and dV a fresh product a (head, 32-query tile), added over the tiles
    and then the heads of each of ``parts`` parts in ascending order, the
    parts' sums then added in ascending order, dK scaled last."""
    H, _, hd = q.shape
    scale, c = 1.0 / math.sqrt(hd), hd // 2

    def halves(a, b):
        return (mm(a[..., :c], b[..., :c].transpose(1, 2))
                + mm(a[..., c:], b[..., c:].transpose(1, 2)))

    s = halves(q, k) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~_mask(window), 0.0)
    ds = p * (halves(do, v) - (do * out).sum(-1)[..., None])
    dq = scale * mm(ds, k)
    dk, dv = torch.zeros_like(k[0]), torch.zeros_like(v[0])
    for part in range(parts):
        pk, pv = torch.zeros_like(dk), torch.zeros_like(dv)
        for h in range(part * H // parts, (part + 1) * H // parts):
            for q0 in range(0, S, 32):
                # the keys a tile of causal queries can see
                lo = 0 if window is None else max(0, q0 - window + 1)
                hi, rows = q0 + 32, slice(q0, q0 + 32)
                pk[lo:hi] += mm(ds[h, rows, lo:hi].T, q[h, rows])
                pv[lo:hi] += mm(p[h, rows, lo:hi].T, do[h, rows])
        dk, dv = dk + pk, dv + pv
    return dq, scale * dk[None], dv[None]


WIDE_CASES = [(None, bwd_parts(1, S, 8, 1, WIDE)),
              (100, bwd_parts(1, S, 8, 1, WIDE)), (None, 2)]


@pytest.mark.parametrize("window,parts", WIDE_CASES)
def test_hd256_summation_order_within_tolerance(window, parts):
    """The hd-256 backward's order of summation in split TF32 (8 query
    heads on 1, S 1024: one head a part as the wrapper splits them at this
    shape, and four heads a part) keeps the gradients within 1e-4 of
    float64."""
    rng = np.random.default_rng(7)
    q, do = (torch.from_numpy(rng.standard_normal((8, S, WIDE)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, S, WIDE)).astype(
        np.float32)) for _ in range(2))
    got, want = [], []
    for dtype, f in ((torch.float32, mm_split), (torch.float64, mm_exact)):
        qq, kk, vv, dd = (t.to(dtype) for t in (q, k, v, do))
        kx, vx = kk.expand(8, -1, -1), vv.expand(8, -1, -1)
        out, lse = forward(qq, kx, vx, window, f)
        if dtype == torch.float32:
            got = backward_pairs(qq, kk, vv, out, lse, dd, window, f, parts)
        else:
            want = backward(qq, kx, vx, out, lse, dd, window, f, 8)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a.double(), b, atol=1e-4, rtol=1e-4)


def forward_pairs(q, k, v, window, mm):
    """(out, lse) of causal attention, q (H, S, hd), k, v (H, S, hd) (MQA
    already by index), in the hd-256 forward kernel's order of summation,
    every product through ``mm``: S as columns 0-127's partial product
    plus columns 128-255's, scaled after the sum; the online softmax over
    32-key tiles; P V a fresh product a tile and a half of the output
    columns, joined to the accumulator as alpha acc + the product."""
    scale, c = 1.0 / math.sqrt(q.shape[-1]), q.shape[-1] // 2
    ok = _mask(window)
    H = q.shape[0]
    m = torch.full((H, S), NEG_INF, dtype=q.dtype)
    l = torch.zeros((H, S), dtype=q.dtype)
    acc = torch.zeros_like(q)
    for k0 in range(0, S, FWD_KEYS):
        kt, vt = k[:, k0:k0 + FWD_KEYS], v[:, k0:k0 + FWD_KEYS]
        s = (mm(q[..., :c], kt[..., :c].transpose(1, 2))
             + mm(q[..., c:], kt[..., c:].transpose(1, 2))) * scale
        s = s.masked_fill(~ok[:, k0:k0 + FWD_KEYS], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        pv = torch.cat([mm(p, vt[..., :c]), mm(p, vt[..., c:])], -1)
        acc = alpha[..., None] * acc + pv
        m = m_new
    return acc / l[..., None], m + torch.log(l)


@pytest.mark.parametrize("H,window", [(8, None), (8, 100), (10, None),
                                      (10, 100)])
def test_hd256_forward_summation_order_within_tolerance(H, window):
    """The hd-256 forward's order of summation in split TF32 (gemma-2b's 8
    and recurrentgemma-2b's 10 query heads on 1, S 1024, causal, with and
    without a window of 100) keeps the output and the log-sum-exp within
    2e-5 of float64."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((H, S, WIDE)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, S, WIDE)).astype(
        np.float32)).expand(H, -1, -1) for _ in range(2))
    got = forward_pairs(q, k, v, window, mm_split)
    want = forward(q.double(), k.double(), v.double(), window, mm_exact)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a.double(), b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("H", [8, 10])
def test_hd256_dkdv_grid_fills_the_sms(H):
    """At gemma-2b's (B 2, S 2048, 8 query heads on 1, hd 256) and
    recurrentgemma-2b's (10 on 1) shapes, the dK/dV kernel's grid (B x the
    pairs of key tiles kt, nkt - 1 - kt x ``bwd_parts``' parts of the
    heads) has a block for every SM, no block more than 1.25x the mean
    block's (head, query tile) iterations under the causal mask, and a
    workspace of partial sums (parts x dK and dV in float32) of at most
    128 MB."""
    B, Sk, hd = 2, 2048, WIDE
    parts = bwd_parts(B, Sk, H, 1, hd)
    nkt, nqt = Sk // TILE, Sk // 32
    iters = []
    for _ in range(B):
        for pair in range((nkt + 1) // 2):
            # a key tile's live query tiles: those past its first key
            live = sum(nqt - TILE * kt // 32 for kt in {pair, nkt - 1 - pair})
            iters += [live * (H // parts)] * parts
    assert len(iters) >= SMS
    assert max(iters) <= 1.25 * sum(iters) / len(iters)
    assert parts * 2 * B * Sk * hd * 4 <= 128 * 2 ** 20


def test_one_pass_tf32_misses_the_tolerance():
    """The control: one product of the TF32 parts errs by ~1e-3, far over
    the forward's 2e-5, so the split is what keeps the tolerance."""
    got, want = _run(1, 1, None, mm_one_pass)
    err = float(torch.max(torch.abs(got[0].double() - want[0])))
    assert err > 2e-5, err
    got, want = _run(1, 1, None, mm_split)
    assert float(torch.max(torch.abs(got[0].double() - want[0]))) < 2e-5


def test_tf32_rounding_is_cvt_rna():
    """Round to nearest on the 13 dropped bits, ties away from zero."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0])
    assert torch.equal(tf32(x), want)


def test_rows_copies_only_what_is_off_16_bytes():
    """A packed (B, S, heads, hd) view is read in place; a tensor whose
    base is 1 float off 16 bytes, or whose row stride is not a multiple of
    4 floats, is copied to a fresh, aligned, contiguous tensor with the
    same values."""
    packed = torch.randn(2, 5, 8, 16)
    q, k, v = packed.split([4, 2, 2], dim=2)
    for t in (q, k, v):
        assert _rows(t) is t
    buf = torch.randn(2 * 5 * 4 * 16 + 1)
    off = buf[1:].view(2, 5, 4, 16)
    assert off.data_ptr() % 16 == 4 and off.is_contiguous()
    got = _rows(off)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, off)
    odd = torch.randn(2, 5, 4, 18)[..., :16]  # row stride 18 floats
    got = _rows(odd)
    assert got is not odd and torch.equal(got, odd)
    assert _rows(odd.to(torch.bfloat16)).is_contiguous()


@pytest.mark.parametrize("hd", [8, 24, 48, 512])
def test_occupancy_refuses_head_dims_without_a_kernel(hd):
    """The kernels are built for hd 16, 32, 64, 96, 128 and 256; any other
    head dim is refused before the library is loaded (so here, without a
    card)."""
    with pytest.raises(ValueError, match="head dims"):
        occupancy(hd, 2048)
