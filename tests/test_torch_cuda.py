"""The port's Hopper kernels on the card, against their plain versions.

Every test needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs on a GPU host that has only
PyTorch (the repository's conftest imports JAX, hence ``--noconftest``):

  python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the mix, on float32, bfloat16 and float16 theta, is
bit-identical to its plain version (both sum over k in the same order with
separately rounded products; asserted with equality, so also within the
stated 1e-6); the column mean likewise to 1e-6 (bit for bit for bfloat16
and float16 panels); the sum of squares to 1e-5 relative (another
summation order). The wire kernels (int8 and int4 quantize and
dequantize, nibble pack and unpack, sparsify) and the merge kernels (the
weighted and the TIES column merge) and the residency kernels (grouped
int8 quantize and dequantize, the fused AdamW step on grouped-int8
moments) are bit-identical to their plain versions (max |err| 0), as are
the TIES thresholds on the card and on the CPU. Segments on the card are
held against the CPU at rtol 1e-3; the fused and unfused residency
segments on the card against each other bit for bit. The flash attention
kernels are held against their plain versions on the card (the online
loop in cuBLAS float32 products, summed in another order): the float32
output and log-sum-exp at 2e-5, the gradients at 1e-4 (each sums up to S
products of the scores' rounding), the bfloat16 output at 2e-2, and the
16-bit kernels' outputs and gradients (bfloat16 and float16, every head
dim) no further from the float32 yardstick than the plain 16-bit
version's, with no spills and three runs the same bits; a strided
view gives the contiguous result bit for bit, a q off 16 bytes (copied by
the wrapper) the aligned q's, and three runs at the attn_block path's
shape the same bits.
The on-chip-seeded int8 quantize is bit-identical to its plain Philox twin
at odd widths; elastic segments (a fault plan with a DEAD and a RESYNC
agent) on the card are held against the CPU at rtol 1e-3 like the others,
their dead rows bit for bit against the card's own state before the kill.
The serving path: a checkpoint restores onto the card bit for bit, and a
blob saved from the card is byte-identical to the one saved from the CPU;
prefill logits on the card within 1e-4 of the CPU's (float32 products in
other orders), and the engine's greedy tokens equal to each request
generated alone on the card.
Telemetry and resumed runs: the segment's per-agent columns on the card
within 1e-4 of the CPU's from one init over two rounds (relative, with
1e-5 absolute), its integer columns equal, and the card's panels and
scalars bit for bit with the columns on and off; a CUDA generator's state
restored through the Checkpointer gives back its initial seed and its next
draws bit for bit.
The recurrent decoders: each mixer's (RG-LRU, mLSTM, sLSTM) train-mode
forward and backward on the card within 1e-4 of the CPU's (gradients
relative to max(1, their largest entry)); decode writing the recurrent
states through the stacked cache's views (the storage kept), the states
and logits within 1e-4 of a whole-sequence prefill; a merged hybrid model
trained on the card and served, its tokens equal to each request alone.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dsgd, panel
from repro_torch.core.schedule import make_schedule
from repro_torch.core.topology import random_matching
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.kernels.merge_ops import ties_colmerge, weighted_colmerge
from repro_torch.kernels.panel_reduce import panel_mean_consensus
from repro_torch.kernels.ref import (dequantize_int4_ref, dequantize_int8_ref,
                                     gossip_mix_ref, int4_group_scale_ref,
                                     int8_scale_ref, pack_int4_ref,
                                     panel_mean_consensus_ref,
                                     quantize_int4_ref, quantize_int8_ref,
                                     sparsify_topk_ref, ties_colmerge_ref,
                                     ties_thresh_ref, topk_threshold_ref,
                                     unpack_int4_ref, weighted_colmerge_ref)
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd,
                                                 occupancy)
from repro_torch.kernels.opt_fused import adamw_fused_int8
from repro_torch.kernels.ref import (adamw_fused_int8_ref,
                                     dequantize_int8_grouped_ref,
                                     flash_attention_bwd_ref,
                                     flash_attention_fwd_ref,
                                     int8_group_scale_ref,
                                     quantize_int8_grouped_ref)
from repro_torch.kernels.ref import quantize_int8_native_ref
from repro_torch.kernels.wire_quant import (dequantize_int4, dequantize_int8,
                                            dequantize_int8_grouped,
                                            pack_int4, quantize_int4,
                                            quantize_int8,
                                            quantize_int8_grouped,
                                            quantize_int8_native,
                                            sparsify_topk, unpack_int4)
from repro_torch.wire import Int4Codec, Int8Codec

pytestmark = pytest.mark.cuda
TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


def _inputs(m, D, seed=0):
    rng = np.random.default_rng(seed)
    W = random_matching(m, 0.7, rng).astype(np.float32)
    W = np.concatenate([W, np.full((1, m), 1.0 / m, np.float32)])
    return W, rng.standard_normal((m, D)).astype(np.float32)


@pytest.mark.parametrize("m,D", [(8, 333), (8, 1000), (4, 64), (16, 4096),
                                 (32, 1001), (8, 1 << 20), (1, 5)])
def test_kernels_match_plain(cuda, m, D):
    W, theta = _inputs(m, D)
    Wc, tc = torch.from_numpy(W).to(cuda), torch.from_numpy(theta).to(cuda)
    for w in (Wc[:m].contiguous(), Wc):
        for t in (tc, tc.to(torch.bfloat16)):
            got, ref = gossip_mix(w, t), gossip_mix_ref(w, t)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and torch.equal(got, ref)
    mean, sq = panel_mean_consensus(tc)
    rmean, rsq = panel_mean_consensus_ref(tc)
    torch.cuda.synchronize()
    torch.testing.assert_close(mean, rmean, atol=TOL, rtol=TOL)
    torch.testing.assert_close(sq, rsq, atol=0.0, rtol=1e-5)
    # a contiguous view one float past an aligned address takes the
    # one-column path of both kernels
    base = torch.empty((m * D + 1,), dtype=torch.float32, device=cuda)
    t1 = base[1:].view(m, D)
    t1.copy_(tc)
    assert torch.equal(gossip_mix(Wc, t1), gossip_mix_ref(Wc, t1))
    torch.testing.assert_close(panel_mean_consensus(t1)[0], rmean,
                               atol=TOL, rtol=TOL)
    b1 = torch.empty((m * D + 1,), dtype=torch.bfloat16, device=cuda)[1:]
    b1 = b1.view(m, D)
    b1.copy_(tc)
    assert torch.equal(gossip_mix(Wc, b1), gossip_mix_ref(Wc, b1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_equal_weight_rows_are_bitwise_equal(cuda, dtype):
    _, theta = _inputs(8, 4099)
    W = torch.full((9, 8), 1.0 / 8, device=cuda)
    out = gossip_mix(W, torch.from_numpy(theta).to(cuda, dtype))
    assert torch.equal(out, out[:1].expand_as(out))


@pytest.mark.parametrize("m,D", [(8, 333), (8, 1000), (4, 64), (32, 1001),
                                 (8, 1 << 20), (1, 5)])
def test_half_entries_match_plain(cuda, m, D):
    """The float16 mix and the bfloat16 / float16 reduce (the parameter
    groups of those dtypes) against their plain versions: the mix and the
    mean bit for bit, the sum of squares to 1e-5 relative; also through the
    one-column path (a view one element past an aligned address)."""
    W, theta = _inputs(m, D)
    Wc, tc = torch.from_numpy(W).to(cuda), torch.from_numpy(theta).to(cuda)
    th = tc.to(torch.float16)
    for w in (Wc[:m].contiguous(), Wc):
        got, ref = gossip_mix(w, th), gossip_mix_ref(w, th)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and torch.equal(got, ref)
    for dt in (torch.bfloat16, torch.float16):
        t = tc.to(dt)
        mean, sq = panel_mean_consensus(t)
        rmean, rsq = panel_mean_consensus_ref(t)
        torch.cuda.synchronize()
        assert mean.dtype == torch.float32 and torch.equal(mean, rmean)
        torch.testing.assert_close(sq, rsq, atol=0.0, rtol=1e-5)
        t1 = torch.empty((m * D + 1,), dtype=dt, device=cuda)[1:].view(m, D)
        t1.copy_(t)
        assert torch.equal(panel_mean_consensus(t1)[0], rmean)
        if dt == torch.float16:
            assert torch.equal(gossip_mix(Wc, t1), gossip_mix_ref(Wc, t1))


def test_wrappers_raise_instead_of_falling_back(cuda):
    t = torch.zeros((4, 16), device=cuda)
    with pytest.raises(TypeError):  # float32, bfloat16 and float16 theta
        gossip_mix(torch.eye(4, device=cuda), t.double())
    with pytest.raises(ValueError):
        gossip_mix(torch.eye(4, device=cuda), t.t())
    with pytest.raises(ValueError):
        gossip_mix(torch.eye(4), t)  # W on the CPU, theta on the card
    with pytest.raises(ValueError):
        panel_mean_consensus(torch.zeros((40, 16), device=cuda))
    with pytest.raises(TypeError):
        panel_mean_consensus(t.double())


def _launch_all(W, theta):
    s = int8_scale_ref(theta)
    q = quantize_int8(theta, s)
    s4 = int4_group_scale_ref(theta)
    q4 = quantize_int4(theta, s4)
    seed = torch.zeros((1,), dtype=torch.int32, device=theta.device)
    return (gossip_mix(W, theta), gossip_mix(W, theta.to(torch.bfloat16)),
            panel_mean_consensus(theta), dequantize_int8(q, s),
            quantize_int8_native(theta, s, seed),
            sparsify_topk(theta, s), dequantize_int4(q4, s4),
            unpack_int4(pack_int4(q4), theta.shape[1]),
            weighted_colmerge(theta, torch.ones_like(theta)),
            ties_colmerge(theta, s), _launch_residency(theta),
            _launch_attention(theta.device))


def _launch_attention(dev):
    q = torch.ones((1, 8, 2, 16), device=dev)
    pos = torch.arange(8, device=dev)[None]
    out, lse = flash_attention_fwd(q, q, q, pos, pos)
    return flash_attention_bwd(q, q, q, out, lse, q, pos, pos)


def _launch_residency(theta):
    s = int8_group_scale_ref(theta, 32)
    q = quantize_int8_grouped(theta, s, None, 32)
    y = dequantize_int8_grouped(q, s, 32)
    u = torch.rand_like(theta)
    return y, adamw_fused_int8(theta, theta.clone(), q, s, q.clone(),
                               s.clone(), u, u, 1e-3, 0.1, 0.001, group=32,
                               transform="sqrt")


def test_launch_counts_only_on_the_card(cuda):
    reset_launch_counts()
    _, theta = _inputs(4, 100)
    W = torch.eye(4)
    _launch_all(W, torch.from_numpy(theta))
    assert set(launch_counts().values()) == {0}
    _launch_all(W.to(cuda), torch.from_numpy(theta).to(cuda))
    assert launch_counts() == {
        "gossip_mix": 2, "gossip_mix_bf16": 1, "gossip_mix_f16": 0,
        "panel_mean_consensus": 1, "panel_mean_consensus_bf16": 0,
        "panel_mean_consensus_f16": 0,
        "quantize_int8": 1, "quantize_int8_native": 1,
        "dequantize_int8": 1, "sparsify_topk": 1, "quantize_int4": 1,
        "dequantize_int4": 1, "pack_int4": 1, "unpack_int4": 1,
        "weighted_colmerge": 1, "ties_colmerge": 1,
        "quantize_int8_grouped": 1, "dequantize_int8_grouped": 1,
        "adamw_fused_int8": 1, "flash_attention_fwd": 1,
        "flash_attention_bwd": 1}


def _quant_inputs(m, D, seed=0):
    """x (m, D) with an all-zero row and a row on exact half steps (amax
    127/64, so the scale is 1/64 and x / s = k + 1/2), and uniforms."""
    rng = np.random.default_rng(seed + D)
    x = rng.standard_normal((m, D)).astype(np.float32)
    x[1] = 0.0
    x[2] = ((rng.integers(-127, 127, size=D) + 0.5) / 64).astype(np.float32)
    x[2, 0] = 127 / 64
    return x, rng.random((m, D), dtype=np.float32)


@pytest.mark.parametrize("m,D", [(8, 333), (8, 1000), (8, 1001), (4, 64),
                                 (3, 4096), (16, 1 << 20), (3, 5)])
def test_wire_kernels_match_plain(cuda, m, D):
    x, u = _quant_inputs(m, D)
    xc, uc = torch.from_numpy(x).to(cuda), torch.from_numpy(u).to(cuda)
    s = int8_scale_ref(xc)
    for uu in (None, uc):
        q, rq = quantize_int8(xc, s, uu), quantize_int8_ref(xc, s, uu)
        torch.cuda.synchronize()
        assert torch.equal(q, rq)
        y = dequantize_int8(q, s)
        torch.cuda.synchronize()
        assert torch.equal(y, dequantize_int8_ref(q, s))
    t = topk_threshold_ref(xc, max(1, D // 8))
    assert t.is_contiguous()
    assert torch.equal(sparsify_topk(xc, t), sparsify_topk_ref(xc, t))
    # views one element past an aligned address take the one-column path
    base = torch.empty((m * D + 1,), dtype=torch.float32, device=cuda)
    x1 = base[1:].view(m, D)
    x1.copy_(xc)
    assert torch.equal(quantize_int8(x1, s, uc), quantize_int8_ref(xc, s, uc))
    assert torch.equal(sparsify_topk(x1, t), sparsify_topk_ref(xc, t))
    qb = torch.empty((m * D + 1,), dtype=torch.int8, device=cuda)[1:]
    q1 = qb.view(m, D)
    q1.copy_(quantize_int8_ref(xc, s))
    assert torch.equal(dequantize_int8(q1, s), dequantize_int8_ref(q1, s))


def test_wire_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((4, 16), device=cuda)
    s = torch.ones((4, 1), device=cuda)
    with pytest.raises(TypeError):
        quantize_int8(x.double(), s)
    with pytest.raises(TypeError):
        dequantize_int8(x, s)  # float32 where int8 is taken
    with pytest.raises(TypeError):
        sparsify_topk(x.to(torch.bfloat16), s)
    with pytest.raises(ValueError):
        quantize_int8(x.t(), s)  # not contiguous
    with pytest.raises(ValueError):
        sparsify_topk(torch.zeros((16, 8), device=cuda)[:, :4], s)
    with pytest.raises(ValueError):
        quantize_int8(x, s.cpu())  # scale on the CPU, x on the card
    with pytest.raises(ValueError):
        quantize_int8(x, s, torch.rand((4, 16)))  # u on the CPU
    with pytest.raises(ValueError):
        sparsify_topk(x, torch.ones((4,), device=cuda))  # not (m, 1)


def _int4_inputs(m, D, group, seed=0):
    """x (m, D) with an all-zero row and a row on exact half steps (every
    group's amax 7/64, so its scale is 1/64 and x / s = k + 1/2), and
    uniforms."""
    rng = np.random.default_rng(seed + D)
    x = rng.standard_normal((m, D)).astype(np.float32)
    x[1] = 0.0
    x[2] = ((rng.integers(-7, 7, size=D) + 0.5) / 64).astype(np.float32)
    x[2, ::group] = 7 / 64
    return x, rng.random((m, D), dtype=np.float32)


@pytest.mark.parametrize("m,D,group", [(8, 333, 128), (8, 1000, 128),
                                       (8, 1001, 128), (4, 64, 32),
                                       (3, 4096, 128), (16, 1 << 20, 128),
                                       (3, 5, 128), (3, 130, 6)])
def test_int4_kernels_match_plain(cuda, m, D, group):
    x, u = _int4_inputs(m, D, group)
    xc, uc = torch.from_numpy(x).to(cuda), torch.from_numpy(u).to(cuda)
    s = int4_group_scale_ref(xc, group)
    assert torch.all(s[2] == 1 / 64)
    for uu in (None, uc):
        q = quantize_int4(xc, s, uu, group)
        torch.cuda.synchronize()
        assert torch.equal(q, quantize_int4_ref(xc, s, uu, group))
        p = pack_int4(q)
        torch.cuda.synchronize()
        assert p.shape == (m, (D + 1) // 2)
        assert torch.equal(p, pack_int4_ref(q))
        back = unpack_int4(p, D)
        torch.cuda.synchronize()
        assert torch.equal(back, unpack_int4_ref(p, D))
        assert torch.equal(back, q)
        y = dequantize_int4(back, s, group)
        torch.cuda.synchronize()
        assert torch.equal(y, dequantize_int4_ref(back, s, group))
    # every nibble value, packed and unpacked, on an odd width
    q8 = torch.arange(-8, 8, dtype=torch.int8, device=cuda).repeat(m, 3)
    q8 = q8[:, :47].contiguous()
    assert torch.equal(unpack_int4(pack_int4(q8), 47), q8)
    # views one element past an aligned address take the one-column paths
    xb = torch.empty((m * D + 1,), dtype=torch.float32, device=cuda)[1:]
    x1 = xb.view(m, D)
    x1.copy_(xc)
    q1 = quantize_int4(x1, s, uc, group)
    assert torch.equal(q1, quantize_int4_ref(xc, s, uc, group))
    qb = torch.empty((m * D + 1,), dtype=torch.int8, device=cuda)[1:]
    qv = qb.view(m, D)
    qv.copy_(q1)
    assert torch.equal(dequantize_int4(qv, s, group),
                       dequantize_int4_ref(q1, s, group))
    assert torch.equal(pack_int4(qv), pack_int4_ref(q1))
    pb = torch.empty((m * ((D + 1) // 2) + 1,), dtype=torch.uint8,
                     device=cuda)[1:]
    pv = pb.view(m, (D + 1) // 2)
    pv.copy_(pack_int4_ref(q1))
    assert torch.equal(unpack_int4(pv, D), q1)


def test_int4_round_to_nearest_takes_ties_to_even(cuda):
    x, _ = _int4_inputs(4, 1001, 128)
    xc = torch.from_numpy(x).to(cuda)
    q = quantize_int4(xc, int4_group_scale_ref(xc)).cpu().numpy()
    ties = np.ones(1001, bool)
    ties[::128] = False
    assert np.all(q[2][ties] % 2 == 0) and np.all(q[1] == 0)


def test_int4_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((4, 256), device=cuda)
    s = torch.ones((4, 2), device=cuda)
    q = torch.zeros((4, 256), dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        quantize_int4(x.double(), s)
    with pytest.raises(ValueError):
        quantize_int4(x, torch.ones((4, 1), device=cuda))  # not (m, G)
    with pytest.raises(ValueError):
        quantize_int4(x, s, torch.rand((4, 256)))  # u on the CPU
    with pytest.raises(TypeError):
        dequantize_int4(x, s)  # float32 where int8 is taken
    with pytest.raises(ValueError):
        dequantize_int4(q, s.cpu())
    with pytest.raises(TypeError):
        pack_int4(q.to(torch.uint8))
    with pytest.raises(ValueError):
        pack_int4(torch.zeros((4, 512), dtype=torch.int8,
                              device=cuda)[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        unpack_int4(torch.zeros((4, 128), dtype=torch.uint8, device=cuda),
                    300)  # 128 bytes hold 255 or 256 columns


def _merge_inputs(m, D, seed=0):
    """x, w and TIES deviations tau (m, D): tau's column 0 has no survivor
    (all of it below every threshold), column 1 a trimmed sum of exactly 0
    (+1 and -1 survive, elected +), and with m >= 2 the rest random."""
    rng = np.random.default_rng(seed + 7 * m + D)
    x = rng.standard_normal((m, D)).astype(np.float32)
    w = rng.uniform(1e-3, 2.0, (m, D)).astype(np.float32)
    tau = rng.standard_normal((m, D)).astype(np.float32)
    tau[:, 0] = 1e-30
    if D > 1:
        tau[:, 1] = 0.0
        tau[0, 1] = 4.0
        if m > 1:
            tau[1, 1] = -4.0
    return x, w, tau


@pytest.mark.parametrize("m,D", [(8, 333), (8, 1000), (8, 1001), (1, 7),
                                 (3, 4096), (16, 1 << 20), (32, 1003),
                                 (2, 1)])
@pytest.mark.parametrize("trim", [0.2, 1.0])
def test_merge_kernels_match_plain(cuda, m, D, trim):
    x, w, tau = (torch.from_numpy(a).to(cuda) for a in _merge_inputs(m, D))
    got = weighted_colmerge(x, w)
    torch.cuda.synchronize()
    assert got.shape == (D,) and torch.equal(got, weighted_colmerge_ref(x, w))
    th = ties_thresh_ref(tau, trim)
    assert torch.equal(th.cpu(), ties_thresh_ref(tau.cpu(), trim))
    got = ties_colmerge(tau, th)
    torch.cuda.synchronize()
    want = ties_colmerge_ref(tau, th)
    assert torch.equal(got, want)
    if trim == 0.2 and D > 1:
        assert float(got[0]) == 0.0  # no survivor
        if m > 1:  # a trimmed sum of exactly 0 elects +: the +4 survives
            assert float(got[1]) == 4.0
    # views one element past an aligned address take the one-column path
    x1, w1, tau1 = (_off_by_one(a) for a in (x, w, tau))
    assert torch.equal(weighted_colmerge(x1, w1), weighted_colmerge_ref(x, w))
    assert torch.equal(ties_colmerge(tau1, th), want)


def _off_by_one(a):
    """A contiguous copy of ``a`` one element past an aligned address."""
    b = torch.empty((a.numel() + 1,), dtype=a.dtype, device=a.device)[1:]
    return b.view(a.shape).copy_(a)


def test_merge_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros((4, 16), device=cuda)
    th = torch.ones((4, 1), device=cuda)
    with pytest.raises(TypeError):
        weighted_colmerge(x.double(), x.double())
    with pytest.raises(ValueError):
        weighted_colmerge(x, x.cpu())  # weights on the CPU
    with pytest.raises(ValueError):
        weighted_colmerge(x, x[:, :8])  # another shape
    with pytest.raises(ValueError):
        weighted_colmerge(x.t().contiguous().t(), x)  # not contiguous
    with pytest.raises(ValueError):
        ties_colmerge(x, torch.ones((4,), device=cuda))  # not (m, 1)
    with pytest.raises(ValueError):
        ties_colmerge(torch.zeros((33, 16), device=cuda),
                      torch.ones((33, 1), device=cuda))  # m > 32
    with pytest.raises(ValueError):
        ties_colmerge(x, th.cpu())


def test_merge_wrappers_launch_on_the_card_only(cuda, monkeypatch):
    """A CUDA tensor reaching merge_ops launches the kernel (the count
    rises) and never runs the plain version."""
    from repro_torch.kernels import merge_ops

    def refuse(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    x, w, tau = (torch.from_numpy(a).to(cuda)
                 for a in _merge_inputs(8, 1000))
    th = ties_thresh_ref(tau, 0.2)
    monkeypatch.setattr(merge_ops, "weighted_colmerge_ref", refuse)
    monkeypatch.setattr(merge_ops, "ties_colmerge_ref", refuse)
    reset_launch_counts()
    weighted_colmerge(x, w)
    ties_colmerge(tau, th)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["weighted_colmerge"] == 1 and counts["ties_colmerge"] == 1
    with pytest.raises(AssertionError, match="plain version"):
        weighted_colmerge(x.cpu(), w.cpu())


def test_panel_ops_match_cpu(cuda):
    _, theta = _inputs(4, 2000, seed=3)
    pan = {"float32": torch.from_numpy(theta)}
    pan_c = {"float32": pan["float32"].to(cuda)}
    W = random_matching(4, 0.9, np.random.default_rng(1)).astype(np.float32)
    mixed, mean, _ = panel.mix_dense_mean(pan, W)
    mixed_c, mean_c, _ = panel.mix_dense_mean(pan_c, W)
    assert torch.equal(mixed_c["float32"].cpu(), mixed["float32"])
    assert torch.equal(mean_c["float32"].cpu(), mean["float32"])
    torch.testing.assert_close(panel.merged(pan_c)["float32"].cpu(),
                               panel.merged(pan)["float32"], atol=TOL,
                               rtol=TOL)
    torch.testing.assert_close(panel.consensus_distance(pan_c).cpu(),
                               panel.consensus_distance(pan), rtol=1e-5,
                               atol=0.0)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if torch.is_tensor(tree) else tree


@pytest.mark.parametrize("wire,merger", [
    (None, None), ("topk", None), ("int8_ef_rtn", None), ("bf16", None),
    ("int4_ef_rtn", None), (None, "weighted"), (None, "var"),
    (None, "fisher"), (None, "ties"), (None, "swa"),
    ("int8_ef_rtn", "ties")])
def test_segment_on_card_matches_cpu(cuda, wire, merger):
    """The reduced olmo-1b segment on the card against the same segment on
    the CPU, on the f32 wire and on the wire paths (the round-to-nearest
    int8_ef and int4_ef: the generators of the card and the CPU give other
    uniforms), and under every non-uniform merge operator: rtol 1e-3,
    since cuBLAS and the CPU's GEMMs sum in other orders and AdamW
    amplifies float32 rounding. After the final merge every row is the
    same; Xi is 0 but under bf16, whose rows are rounded through bf16
    while the folded mean stays float32."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import (build_cpu_preset,
                                          sample_segment_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    m, rounds, H = 4, 4, 2
    cfg = build_cpu_preset(get_config("olmo-1b"), m)
    model = build_model(cfg)
    sched = make_schedule("final_merge", m, rounds, prob=0.2, seed=0)
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(rounds)]).astype(np.float32)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = sample_segment_batches(
        lm, lm.domain_mixtures(m, 0.1, seed=1), rounds, H, 4, 32,
        np.random.default_rng(2))
    name = wire
    if wire == "int8_ef_rtn":
        wire = {"float32": Int8Codec("int8_ef", stochastic=False,
                                     error_feedback=True)}
    if wire == "int4_ef_rtn":
        wire = {"float32": Int4Codec("int4_ef", stochastic=False,
                                     error_feedback=True)}
    mets = {}
    for dev in ("cpu", cuda):
        opt = make_optimizer("adamw", 3e-3, total_steps=rounds * H)
        state, spec = dsgd.init_panel_state(model.init_params, opt, m, 0,
                                            device="cpu", wire=wire,
                                            merger=merger)
        state = {k: v for k, v in state.items() if k != "opt"}
        state = {k: _to(v, dev) for k, v in state.items()}
        state["opt"] = opt.init(state["panel"])
        seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
        state, out = seg(state, batches, Ws)
        mets[str(dev)] = {k: v.cpu().numpy() for k, v in out.items()}
        x = state["panel"]["float32"]
        assert torch.equal(x, x[:1].expand_as(x))
    for k in mets["cpu"]:
        np.testing.assert_allclose(mets["cuda"][k], mets["cpu"][k],
                                   rtol=1e-3, atol=1e-5)
    assert name == "bf16" or mets["cuda"]["consensus"][-1] == 0.0


def _fused_args(m, D, group, seed=0):
    """The fused step's inputs on the card: companded grouped-int8 moments
    (row 1's first group of m and of g zero: its new m is a zero group),
    uniforms, per-agent lr / bc1 / bc2 columns."""
    from repro_torch.residency import Int8Storage
    st = Int8Storage("t", group=group, transform="sqrt")
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, D)).astype(np.float32) * 0.1
    x = rng.normal(size=(m, D)).astype(np.float32) * 1e-2
    if m > 1:
        g[1, :group] = 0.0
        x[1, :group] = 0.0
    v = np.square(rng.normal(size=(m, D))).astype(np.float32) * 1e-4
    dev = torch.device("cuda")
    mom, vel = (st.init(torch.from_numpy(a)) for a in (x, v))
    c = np.arange(1, m + 1, dtype=np.float32)[:, None]
    args = [torch.from_numpy(g), torch.from_numpy(
        rng.normal(size=(m, D)).astype(np.float32)), mom["q"], mom["scale"],
        vel["q"], vel["scale"],
        torch.from_numpy(rng.random((m, D), dtype=np.float32)),
        torch.from_numpy(rng.random((m, D), dtype=np.float32)),
        torch.full((m, 1), 3e-3), torch.from_numpy(1 - 0.9 ** c),
        torch.from_numpy(1 - 0.999 ** c)]
    return [a.to(dev) for a in args]


HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=5e-4)


@pytest.mark.parametrize("m,D,group", [(8, 333, 128), (8, 1000, 32),
                                       (8, 1001, 128), (1, 1001, 32),
                                       (16, 1001, 128), (16, 4099, 32),
                                       (8, 4100, 128),
                                       (8, 1 << 20, 128)])
def test_residency_kernels_match_plain(cuda, m, D, group):
    g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2 = _fused_args(m, D, group)
    x = torch.randn((m, D), device=cuda)
    if m > 1:
        x[1, :group] = 0.0  # an all-zero group: scale 1/127
    s = int8_group_scale_ref(x, group)
    assert torch.equal(s.cpu(), int8_group_scale_ref(x.cpu(), group))
    for u in (um, None):
        q = quantize_int8_grouped(x, s, u, group)
        assert torch.equal(q, quantize_int8_grouped_ref(x, s, u, group))
    assert torch.equal(dequantize_int8_grouped(q, s, group),
                       dequantize_int8_grouped_ref(q, s, group))
    # a slab of whole groups of the wider panel, in place
    out = torch.zeros_like(q)
    quantize_int8_grouped(x[:, group:], s[:, 1:], um[:, group:], group,
                          out=out[:, group:])
    assert torch.equal(out[:, group:], quantize_int8_grouped_ref(
        x, s, um, group)[:, group:])
    kw = dict(group=group, transform="sqrt", **HP)
    want = adamw_fused_int8_ref(g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2,
                                **kw)
    got = [t.clone() for t in (p, qm, sm, qv, sv)]
    adamw_fused_int8(g, *got, um, uv, lr, bc1, bc2, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if m > 1:
        assert float(got[2][1, 0]) == float(torch.tensor(1.0) / 127.0)
    got = [t.clone() for t in (p, qm, sm, qv, sv)]
    sl = [got[0][:, group:], got[1][:, group:], got[2][:, 1:],
          got[3][:, group:], got[4][:, 1:]]
    adamw_fused_int8(g[:, group:], *sl, um[:, group:], uv[:, group:], lr,
                     bc1, bc2, **kw)
    want = adamw_fused_int8_ref(g[:, group:], p[:, group:], qm[:, group:],
                                sm[:, 1:], qv[:, group:], sv[:, 1:],
                                um[:, group:], uv[:, group:], lr, bc1, bc2,
                                **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(sl, want))
    assert torch.equal(got[0][:, :group], p[:, :group])


def test_residency_wrappers_raise_instead_of_falling_back(cuda):
    g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2 = _fused_args(4, 300, 32)
    with pytest.raises(ValueError):  # float64 panel
        quantize_int8_grouped(g.double(), sm, None, 32)
    with pytest.raises(ValueError):  # scales of the wrong width
        quantize_int8_grouped(g, sm[:, 1:], None, 32)
    with pytest.raises(ValueError):  # a column stride
        dequantize_int8_grouped(qm.t().contiguous().t(), sm, 32)
    with pytest.raises(ValueError):  # the scale on the CPU
        quantize_int8_grouped(g, sm.cpu(), None, 32)
    with pytest.raises(ValueError):  # q and p with different row strides
        adamw_fused_int8(g, p, qm[:, :288], sm[:, :9], qv, sv, um, uv, lr,
                         bc1, bc2, group=32)
    with pytest.raises(ValueError):
        adamw_fused_int8(g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2,
                         group=2048)
    with pytest.raises(ValueError):
        adamw_fused_int8(g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2,
                         group=32, transform="log")


def _residency_segment(dev, policy, fused=None, rounds=3):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import (build_cpu_preset,
                                          sample_segment_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    m, H = 4, 2
    cfg = build_cpu_preset(get_config("olmo-1b"), m)
    model = build_model(cfg)
    sched = make_schedule("final_merge", m, rounds, prob=0.2, seed=0)
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(rounds)]).astype(np.float32)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = sample_segment_batches(
        lm, lm.domain_mixtures(m, 0.1, seed=1), rounds, H, 4, 32,
        np.random.default_rng(2))
    opt = make_optimizer("adamw", 3e-3, total_steps=rounds * H)
    state, spec = dsgd.init_panel_state(model.init_params, opt, m, 0,
                                        device="cpu", residency=policy)
    state = _to(state, dev)
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec, fused=fused)
    state, out = seg(state, batches, Ws, 7)
    return state, {k: v.cpu().numpy() for k, v in out.items()}


def test_fused_segment_on_card_equals_unfused(cuda):
    """The fused kernel and the unfused read -> AdamW -> write draw the same
    uniforms in the same slabs: the card's two segments agree bit for bit,
    and the fused one launched the kernel in every local step."""
    reset_launch_counts()
    a, ma = _residency_segment(cuda, "moments=int8", fused=True)
    assert launch_counts()["adamw_fused_int8"] == 3 * 2
    reset_launch_counts()
    b, mb = _residency_segment(cuda, "moments=int8", fused=False)
    counts = launch_counts()
    assert counts["adamw_fused_int8"] == 0
    assert counts["quantize_int8_grouped"] == 3 * 2 * 2
    assert counts["dequantize_int8_grouped"] == 3 * 2 * 2
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k])
    assert torch.equal(a["panel"]["float32"], b["panel"]["float32"])
    for mk in ("m", "v"):
        for part in ("q", "scale"):
            assert torch.equal(a["opt"][mk]["float32"][part],
                               b["opt"][mk]["float32"][part])


@pytest.mark.parametrize("policy", ["moments=int8", "moments=bf16",
                                    "moments=int8g"])
def test_residency_segment_on_card_matches_cpu(cuda, policy):
    """Loss and Xi at rtol 1e-3 as the other segments. The stochastic
    storages draw other uniforms on the card than on the CPU, and the grad
    norms follow those draws more closely (int8 moments: 1.07e-3 relative,
    the H100 80GB HBM3 at 700 W): they are held at 1e-2."""
    _, mc = _residency_segment(cuda, policy)
    _, mh = _residency_segment("cpu", policy)
    for k in mh:
        np.testing.assert_allclose(
            mc[k], mh[k], atol=1e-5,
            rtol=1e-3 if k in ("loss", "consensus") else 1e-2)
    assert mc["consensus"][-1] == 0.0


def _attention_inputs(B, S, H, Kv, hd, seed, dev):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev) for shape in ((B, S, H, hd), (B, S, Kv, hd),
                                           (B, S, Kv, hd), (B, S, H, hd)))
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    return q, k, v, do, pos


# (B, S, H, Kv, hd, causal, window): key and query tails (S % 64 != 0),
# GQA, windows, no causal mask, every head dim the kernels take, a single
# position, the attn_block path's own shape, and GQA over 2048 positions
# (the longest sums of dK and dV: 4 query heads a key head); at hd 96
# (phi3-mini) and 256 (gemma-2b; the warp pairs) GQA, MQA
# (gemma's 8 query heads on one key head; recurrentgemma's 10, with a
# window and a tail), windows, no causal mask, and gemma's attn_block cell
# (B 2, S 2048, MQA)
ATTENTION = [(2, 100, 4, 2, 64, True, None), (1, 100, 2, 2, 128, True, None),
             (2, 256, 8, 2, 32, True, 64), (2, 130, 4, 4, 16, True, 40),
             (1, 77, 2, 1, 64, False, None), (2, 64, 2, 2, 128, True, None),
             (1, 300, 4, 1, 128, True, 100), (2, 1, 2, 1, 128, True, None),
             (2, 2048, 16, 16, 128, True, None),
             (2, 2048, 32, 8, 128, True, None),
             (2, 100, 4, 2, 96, True, None), (1, 300, 8, 1, 96, True, 100),
             (1, 77, 2, 2, 96, False, None), (2, 100, 8, 1, 256, True, None),
             (1, 130, 4, 2, 256, True, 48), (1, 77, 2, 1, 256, False, None),
             (2, 1, 2, 1, 256, True, None), (2, 2048, 8, 1, 256, True, None),
             (1, 300, 10, 1, 256, True, 100)]


@pytest.mark.parametrize("B,S,H,Kv,hd,causal,window", ATTENTION)
def test_flash_attention_kernels_match_plain(cuda, B, S, H, Kv, hd, causal,
                                             window):
    q, k, v, do, pos = _attention_inputs(B, S, H, Kv, hd, S + hd, cuda)
    kw = dict(causal=causal, window=window)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, pos, pos, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, pos, pos, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_fwd"] == 1
    assert launch_counts()["flash_attention_bwd"] == 1
    r_out, r_lse = flash_attention_fwd_ref(q, k, v, pos, pos, **kw)
    torch.testing.assert_close(out, r_out, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, r_lse, atol=2e-5, rtol=2e-5)
    for g, r in zip(grads, flash_attention_bwd_ref(q, k, v, do, pos, pos,
                                                   **kw)):
        assert g.shape == r.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
    # strided views (q, k, v inside one packed tensor) read in place give
    # the same bits; so does a second run
    packed = torch.cat([q, k, v], dim=2)
    qs, ks, vs = packed.split([H, Kv, Kv], dim=2)
    assert not qs.is_contiguous()
    out2, lse2 = flash_attention_fwd(qs, ks, vs, pos, pos, **kw)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    grads2 = flash_attention_bwd(qs, ks, vs, out, lse, do, pos, pos, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads2, grads))
    # through autograd, as the train path calls it
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = FlashAttention.apply(*leaves, pos, pos, causal, window,
                             1.0 / np.sqrt(hd))
    assert torch.equal(y.detach(), out)
    auto = torch.autograd.grad(y, leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


def test_flash_attention_unaligned_input_is_copied(cuda):
    """A q and a dO whose storage starts 1 float off 16 bytes cannot feed
    the kernels' 16-byte copies: the wrapper copies them to fresh tensors,
    and the results are the aligned inputs' bit for bit."""
    q, k, v, do, pos = _attention_inputs(2, 100, 4, 2, 128, 11, cuda)

    def off_by_one_float(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        u = buf[1:].view(t.shape)
        u.copy_(t)
        assert u.data_ptr() % 16 == 4 and u.is_contiguous()
        return u

    qu, dou = off_by_one_float(q), off_by_one_float(do)
    out, lse = flash_attention_fwd(q, k, v, pos, pos)
    out_u, lse_u = flash_attention_fwd(qu, k, v, pos, pos)
    assert torch.equal(out_u, out) and torch.equal(lse_u, lse)
    grads = flash_attention_bwd(q, k, v, out, lse, do, pos, pos)
    grads_u = flash_attention_bwd(qu, k, v, out, lse, dou, pos, pos)
    assert all(torch.equal(a, b) for a, b in zip(grads_u, grads))
    r_out, _ = flash_attention_fwd_ref(q, k, v, pos, pos)
    torch.testing.assert_close(out_u, r_out, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("H,Kv,hd", [(16, 16, 128), (8, 1, 256),
                                     (10, 1, 256)])
def test_flash_attention_runs_are_bit_identical(cuda, H, Kv, hd):
    """Three runs of the forward and backward kernels at the attn_block
    path's shape (B 2, S 2048, H 16, hd 128, causal) and at gemma-2b's and
    recurrentgemma-2b's MQA shapes (hd 256: 8 and 10 query heads on one,
    dK/dV's partial sums over the heads' parts) give the same bits: every
    sum runs in a fixed order and no output is shared."""
    q, k, v, do, pos = _attention_inputs(2, 2048, H, Kv, hd, 5, cuda)
    runs = []
    for _ in range(3):
        out, lse = flash_attention_fwd(q, k, v, pos, pos)
        runs.append((out, lse) + tuple(flash_attention_bwd(
            q, k, v, out, lse, do, pos, pos)))
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def test_flash_attention_kernels_fit_two_blocks_without_spills(cuda):
    """At hd 128 and S 2048 every kernel keeps its values in registers (no
    local memory a thread) and runs at least two blocks an SM (the 16-bit
    forward: blocks of one warpgroup)."""
    for name, r in occupancy(128, 2048).items():
        assert r["registers"] > 0 and r["local_bytes"] == 0, (name, r)
        assert r["blocks_per_sm"] >= 2, (name, r)


@pytest.mark.parametrize("hd", [96, 256])
def test_flash_attention_wide_heads_fit_without_spills(cuda, hd):
    """At hd 96 and 256 every kernel keeps its values in registers (no
    local memory a thread); hd 96 runs two 4-warp blocks an SM; at hd 256
    8 warps an SM: the float32 forward's and backward's 8-warp blocks
    (warp pairs, 216,480 to 216,736 bytes of tiles and exchange slots)
    one, the 16-bit forward's block of two warpgroups one, the 16-bit
    backward's 4-warp blocks two."""
    for name, r in occupancy(hd, 2048).items():
        assert r["registers"] > 0 and r["local_bytes"] == 0, (name, r)
        if hd == 96:
            assert r["blocks_per_sm"] >= 2, (name, r)
        else:
            assert r["warps_per_sm"] >= 8, (name, r)


@pytest.mark.parametrize("hd,Kv,window", [(96, 2, None), (96, 1, 40),
                                          (256, 1, None), (256, 2, 48)])
def test_flash_attention_bf16_forward_wide_heads(cuda, hd, Kv, window):
    q, k, v, _, pos = _attention_inputs(2, 130, 4, Kv, hd, hd + Kv, cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out, lse = flash_attention_fwd(q, k, v, pos, pos, window=window)
    r_out, r_lse = flash_attention_fwd_ref(q, k, v, pos, pos, window=window)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), r_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, r_lse, atol=2e-2, rtol=2e-2)


def test_flash_attention_bf16_forward(cuda):
    q, k, v, do, pos = _attention_inputs(2, 100, 4, 2, 64, 3, cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out, lse = flash_attention_fwd(q, k, v, pos, pos, window=48)
    r_out, r_lse = flash_attention_fwd_ref(q, k, v, pos, pos, window=48)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), r_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, r_lse, atol=2e-2, rtol=2e-2)
    # the backward takes bfloat16 too (fault C1's repair), dO in q's dtype
    grads = flash_attention_bwd(q, k, v, out, lse, do.to(torch.bfloat16),
                                pos, pos, window=48)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    with pytest.raises(TypeError):  # dO in another dtype than q's
        flash_attention_bwd(q, k, v, out, lse, do, pos, pos)


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# the 16-bit kernels against the plain 16-bit version: each output at most
# FLASH16_FACTOR times the plain version's relative l2 distance from the
# float32 yardstick (the plain version on the same values widened), as
# chip_smoke.py's phase 3 holds them (0.39-0.60 of it read there)
FLASH16_FACTOR = 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("Kv,window,causal", [(2, None, True),
                                              (1, 40, True),
                                              (2, None, False)])
def test_flash_attention_16bit_kernels_match_plain(cuda, dtype, hd, Kv,
                                                   window, causal):
    q, k, v, do, pos = _attention_inputs(2, 100, 4, Kv, hd, hd + Kv, cuda)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    kw = dict(causal=causal, window=window)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, pos, pos, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, pos, pos, **kw)
    torch.cuda.synchronize()
    sfx = "bf16" if dtype == torch.bfloat16 else "f16"
    counts = launch_counts()
    assert counts[f"flash_attention_fwd_{sfx}"] == 1
    assert counts[f"flash_attention_bwd_{sfx}"] == 1
    plain = (flash_attention_fwd_ref(q, k, v, pos, pos, **kw)[0],) + tuple(
        flash_attention_bwd_ref(q, k, v, do, pos, pos, **kw))
    w = [t.float() for t in (q, k, v, do)]
    yard = (flash_attention_fwd_ref(*w[:3], pos, pos, **kw)[0],) + tuple(
        flash_attention_bwd_ref(*w, pos, pos, **kw))
    for got, p, y in zip((out,) + tuple(grads), plain, yard):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert _rel_l2(got, y) <= FLASH16_FACTOR * _rel_l2(p, y)
    # through autograd, as the train path calls it
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y_ = FlashAttention.apply(*leaves, pos, pos, causal, window,
                              1.0 / np.sqrt(hd))
    auto = torch.autograd.grad(y_, leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
def test_flash_attention_16bit_kernels_fit_without_spills(cuda, hd):
    """The bfloat16 and float16 kernels (``csrc/flash_attention16.cu``)
    keep their values in registers (no local memory a thread) and run at
    least 8 warps an SM at every head dim (S 2048)."""
    for name, r in occupancy(hd, 2048).items():
        if name.endswith("float32"):
            continue
        assert r["registers"] > 0 and r["local_bytes"] == 0, (name, r)
        assert r["warps_per_sm"] >= 8, (name, r)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("H,Kv,hd", [(16, 16, 128), (8, 1, 256)])
def test_flash_attention_16bit_runs_are_bit_identical(cuda, dtype, H, Kv,
                                                      hd):
    """Three runs of the 16-bit forward and backward kernels at the
    attn_block path's shape and gemma-2b's MQA shape (dK/dV's column
    blocks and parts) give the same bits."""
    q, k, v, do, pos = _attention_inputs(2, 2048, H, Kv, hd, 7, cuda)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    runs = []
    for _ in range(3):
        out, lse = flash_attention_fwd(q, k, v, pos, pos)
        runs.append((out, lse) + tuple(flash_attention_bwd(
            q, k, v, out, lse, do, pos, pos)))
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def test_flash_attention_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v, do, pos = _attention_inputs(1, 8, 2, 2, 16, 0, cuda)
    with pytest.raises(TypeError):  # float64 is no kernel's type
        flash_attention_fwd(q.double(), k.double(), v.double(), pos, pos)
    with pytest.raises(ValueError):  # head dim 24 is not a kernel's
        flash_attention_fwd(q[..., :12], k[..., :12], v[..., :12], pos, pos)
    with pytest.raises(ValueError):  # 2 query heads on 3 kv heads
        flash_attention_fwd(q, torch.cat([k, k[:, :, :1]], 2),
                            torch.cat([v, v[:, :, :1]], 2), pos, pos)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k.cpu(), v, pos, pos)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, pos, pos, window=0)


def test_blockwise_segment_on_card_matches_cpu(cuda):
    """The reduced olmo-1b segment with attn_block 8 at seq 32 on the card
    (the flash attention kernels, forward and backward) against the CPU
    (the plain loop): rtol 1e-3 on loss and Xi, as the other segments;
    after the final merge the rows are equal and Xi is 0."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import (build_cpu_preset,
                                          sample_segment_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    m, rounds, H = 4, 4, 2
    cfg = build_cpu_preset(get_config("olmo-1b"), m)
    cfg = cfg.replace(dist=dataclasses.replace(cfg.dist, attn_block=8))
    model = build_model(cfg)
    sched = make_schedule("final_merge", m, rounds, prob=0.2, seed=0)
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(rounds)]).astype(np.float32)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = sample_segment_batches(
        lm, lm.domain_mixtures(m, 0.1, seed=1), rounds, H, 4, 32,
        np.random.default_rng(2))
    mets = {}
    reset_launch_counts()
    for dev in ("cpu", cuda):
        opt = make_optimizer("adamw", 3e-3, total_steps=rounds * H)
        state, spec = dsgd.init_panel_state(model.init_params, opt, m, 0,
                                            device="cpu")
        state = {k: _to(v, dev) for k, v in state.items()}
        seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
        state, out = seg(state, batches, Ws)
        mets[str(dev)] = {k: v.cpu().numpy() for k, v in out.items()}
        x = state["panel"]["float32"]
        assert torch.equal(x, x[:1].expand_as(x))
    counts = launch_counts()
    # 2 layers x 4 agents x 2 local steps x 4 rounds
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 64
    for key in ("loss", "consensus"):
        np.testing.assert_allclose(mets["cuda"][key], mets["cpu"][key],
                                   rtol=1e-3, atol=1e-5)
    assert mets["cuda"]["consensus"][-1] == 0.0


@pytest.mark.parametrize("m,D", [(8, 1), (8, 3), (8, 511), (8, 513),
                                 (8, 4097), (3, 1000), (1, 2048)])
def test_native_quantize_matches_twin(cuda, m, D):
    """The in-kernel Philox draws equal the plain twin's bit for bit (the
    seed read on the card), at widths off 4 and off 512; one launch each."""
    g = torch.Generator(device=cuda).manual_seed(m * 7 + D)
    x = torch.randn((m, D), generator=g, device=cuda)
    x[0, :2] = 0.0
    s = int8_scale_ref(x)
    for seed in (0, -1, 2 ** 31 - 1, 12345):
        t = torch.tensor([seed], dtype=torch.int32, device=cuda)
        reset_launch_counts()
        q = quantize_int8_native(x, s, t)
        assert launch_counts()["quantize_int8_native"] == 1
        ref = quantize_int8_native_ref(x, s, t)
        torch.cuda.synchronize()
        assert torch.equal(q, ref), (seed, int(torch.max(torch.abs(
            q.int() - ref.int()))))


def test_native_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.randn((4, 100), device=cuda)
    s = int8_scale_ref(x)
    for seed in (torch.tensor([1], dtype=torch.int32),
                 torch.tensor([1], dtype=torch.int64, device=cuda),
                 torch.tensor([1, 2], dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError):
            quantize_int8_native(x, s, seed)


def _live_segment(dev, wire=None, merger=None, policy=None, fused=None):
    """Reduced olmo-1b, m = 4, 4 rounds under the plan 2@1-2;3@2 (agent 2
    DEAD then RESYNC, agent 3 DEAD from round 2), the schedule's degraded
    W and global marks, in two segments; returns the state after round 1
    and after round 3, and the metrics."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultPlan
    from repro_torch.launch.train import (build_cpu_preset,
                                          sample_segment_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    m, rounds, H = 4, 4, 2
    cfg = build_cpu_preset(get_config("olmo-1b"), m)
    model = build_model(cfg)
    plan = FaultPlan.parse(m, "2@1-2;3@2")
    sched = make_schedule("final_merge", m, rounds, prob=0.5, seed=0,
                          merger=merger or "uniform", faults=plan)
    Ws, glob, live = [], [], []
    for t in range(rounds):
        Ws.append(sched.mixing_matrix(t))
        glob.append(sched.last_kind == "global")
        live.append(sched.last_live)
    Ws = np.stack(Ws).astype(np.float32)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = sample_segment_batches(
        lm, lm.domain_mixtures(m, 0.1, seed=1), rounds, H, 4, 32,
        np.random.default_rng(2))
    opt = make_optimizer("adamw", 3e-3, total_steps=rounds * H)
    state, spec = dsgd.init_panel_state(model.init_params, opt, m, 0,
                                        device="cpu", wire=wire,
                                        merger=merger, residency=policy)
    state = _to(state, dev)
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec, fused=fused)
    mets, snaps = [], []
    for part in (slice(0, 2), slice(2, 4)):
        state, out = seg(state, {k: v[part] for k, v in batches.items()},
                         Ws[part], 7, global_rounds=np.asarray(glob)[part],
                         live=np.stack(live)[part])
        mets.append({k: v.cpu().numpy() for k, v in out.items()})
        snaps.append(_to(state, "cpu"))
    return snaps, {k: np.concatenate([a[k], b[k]]) for a, b in [mets]
                   for k in a}


@pytest.mark.parametrize("wire,merger,policy,fused", [
    (None, None, None, None), (None, "ties", None, None),
    (None, None, "moments=int8", True), (None, None, "moments=int8", False)])
def test_live_segment_on_card_matches_cpu(cuda, wire, merger, policy, fused):
    """An elastic segment on the card against the CPU (rtol 1e-3); on the
    card the dead agent 3's rows (parameters, stored moment bits) after the
    last round equal its rows after round 1, the live rows are identical
    after the final merge and the live Xi is 0."""
    snaps, mc = _live_segment(cuda, wire, merger, policy, fused)
    _, mh = _live_segment("cpu", wire, merger, policy, fused)
    for k in mh:
        np.testing.assert_allclose(
            mc[k], mh[k], atol=1e-5,
            rtol=1e-3 if policy is None or k in ("loss", "consensus")
            else 1e-2)
    early, last = snaps
    assert torch.equal(last["panel"]["float32"][3],
                       early["panel"]["float32"][3])
    for mk in ("m", "v"):
        a, b = last["opt"][mk]["float32"], early["opt"][mk]["float32"]
        for part in (("q", "scale") if policy else (None,)):
            x, y = (a, b) if part is None else (a[part], b[part])
            assert torch.equal(x[3], y[3])
    x = last["panel"]["float32"]
    assert torch.equal(x[:3], x[:1].expand(3, -1))
    assert mc["consensus"][-1] == 0.0


def test_native_codec_segment_on_card(cuda):
    """int8_ef with the kernel's draws on the card: the native quantize in
    every communicating round, the supplied-uniform one never; rows
    identical and Xi 0 after the final merge."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import (build_cpu_preset,
                                          sample_segment_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    m, rounds, H = 4, 4, 2
    cfg = build_cpu_preset(get_config("olmo-1b"), m)
    model = build_model(cfg)
    sched = make_schedule("final_merge", m, rounds, prob=0.5, seed=0)
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(rounds)]).astype(np.float32)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = sample_segment_batches(
        lm, lm.domain_mixtures(m, 0.1, seed=1), rounds, H, 4, 32,
        np.random.default_rng(2))
    opt = make_optimizer("adamw", 3e-3, total_steps=rounds * H)
    codec = Int8Codec("int8_ef", error_feedback=True, draws="kernel")
    state, spec = dsgd.init_panel_state(model.init_params, opt, m, 0,
                                        device=cuda, wire=codec)
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
    reset_launch_counts()
    state, out = seg(state, batches, Ws,
                     torch.Generator(device=cuda).manual_seed(3))
    counts = launch_counts()
    eye = np.eye(m, dtype=np.float32)
    comm = sum(not np.array_equal(W, eye) for W in Ws)
    assert counts["quantize_int8_native"] == comm > 0
    assert counts["quantize_int8"] == 0
    x = state["panel"]["float32"]
    assert torch.equal(x, x[:1].expand_as(x))
    assert float(out["consensus"][-1]) == 0.0


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A blob saved from CPU tensors restores onto the devices of the
    ``like`` tree's tensors, bit for bit (bfloat16 by its bits)."""
    from repro_torch.checkpoint import restore, save
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((70, 300), generator=gen),
            "e": torch.randn(5, generator=gen).to(torch.bfloat16),
            "q": torch.arange(-4, 4, dtype=torch.int8), "norm": {}}
    path = str(tmp_path / "s.ckpt")
    save(path, tree)
    like = {**tree, "w": tree["w"].to(cuda), "e": tree["e"].to(cuda)}
    back = restore(path, like)
    assert back["w"].device.type == "cuda" and back["q"].device.type == "cpu"
    for k in ("w", "e", "q"):
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k].cpu(), tree[k])
    save(str(tmp_path / "card.ckpt"), back)  # saved from the card
    assert (tmp_path / "card.ckpt").read_bytes() == open(path, "rb").read()


@pytest.mark.parametrize("attn_block", [0, 8])
def test_engine_on_the_card(cuda, attn_block):
    """The serving path on the card (reduced olmo-1b): prefill logits
    within 1e-4 of the CPU's (float32 products in other orders), the
    engine's greedy tokens equal to generate of each request alone on the
    card, the flash attention forward kernel launched by the attn_block
    prefill (under no_grad) and never by decode."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine, generate
    from repro_torch.utils.tree import tree_map
    cfg = get_config("olmo-1b").reduced(d_model=128, vocab=256)
    cfg = cfg.replace(dist=dataclasses.replace(cfg.dist,
                                               attn_block=attn_block))
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda x: x.to(cuda), params)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, 256, [24, 13][i % 2])
                    .astype(np.int32), max_new=6) for i in range(5)]
    toks = torch.from_numpy(reqs[0].tokens[None])
    with torch.no_grad():
        cpu_logits, _ = model.prefill(params, {"tokens": toks}, max_len=40)
    reset_launch_counts()
    with torch.no_grad():
        logits, _ = model.prefill(card, {"tokens": toks.to(cuda)},
                                  max_len=40)
    assert launch_counts()["flash_attention_fwd"] == (
        cfg.num_layers if attn_block else 0)
    np.testing.assert_allclose(logits.cpu().numpy(), cpu_logits.numpy(),
                               rtol=1e-4, atol=1e-4)
    eng = ServingEngine(model, card, max_concurrency=3, max_len=40)
    reset_launch_counts()
    out = eng.serve(reqs)
    assert launch_counts()["flash_attention_fwd"] == (
        5 * cfg.num_layers if attn_block else 0)
    for r in reqs:
        alone = generate(model, card, {"tokens": torch.from_numpy(
            r.tokens[None]).to(cuda)}, r.max_new, max_len=40)[0]
        np.testing.assert_array_equal(out[r.rid], alone)


@pytest.mark.parametrize("wire", [None, "int8_ef_rtn", "topk"])
def test_telemetry_segment_on_card_matches_cpu(cuda, wire):
    """make_panel_segment(telemetry=True) on the card against the CPU from
    one init, over two rounds (a gossip round and the final merge): the
    float columns within 1e-4, the integer columns (live, wire_bytes)
    equal; on the card the panels and the scalar metrics are the same bits
    with the columns on and off."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import (build_cpu_preset,
                                          sample_segment_batches)
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.telemetry.metrics import AGENT_COLUMNS
    m, rounds, H = 4, 2, 2
    cfg = build_cpu_preset(get_config("olmo-1b"), m)
    model = build_model(cfg)
    sched = make_schedule("final_merge", m, rounds, prob=0.5, seed=0)
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(rounds)]).astype(np.float32)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = sample_segment_batches(
        lm, lm.domain_mixtures(m, 0.1, seed=1), rounds, H, 4, 32,
        np.random.default_rng(2))
    if wire == "int8_ef_rtn":
        wire = {"float32": Int8Codec("int8_ef", stochastic=False,
                                     error_feedback=True)}
    mets, panels = {}, {}
    for dev, tel in (("cpu", True), (cuda, True), (cuda, False)):
        opt = make_optimizer("adamw", 3e-3, total_steps=rounds * H)
        state, spec = dsgd.init_panel_state(model.init_params, opt, m, 0,
                                            device="cpu", wire=wire)
        state = {k: v for k, v in state.items() if k != "opt"}
        state = {k: _to(v, dev) for k, v in state.items()}
        state["opt"] = opt.init(state["panel"])
        seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec,
                                      telemetry=tel)
        state, out = seg(state, batches, Ws)
        key = (str(dev), tel)
        mets[key] = {k: v.cpu().numpy() for k, v in out.items()}
        panels[key] = state["panel"]["float32"].cpu()
    cpu, card, off = (mets[("cpu", True)], mets[("cuda", True)],
                      mets[("cuda", False)])
    assert set(card) - set(off) == set(AGENT_COLUMNS)
    for k in ("loss_agent", "grad_norm_agent", "dist_to_mean"):
        assert card[k].shape == (rounds, m)
        np.testing.assert_allclose(card[k], cpu[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k in ("live", "wire_bytes"):
        np.testing.assert_array_equal(card[k], cpu[k])
    assert torch.equal(panels[("cuda", True)], panels[("cuda", False)])
    for k in off:
        np.testing.assert_array_equal(card[k], off[k])
    np.testing.assert_allclose(
        np.sqrt(np.mean(card["dist_to_mean"] ** 2, axis=1)),
        card["consensus"], rtol=1e-4, atol=0.0)
    assert card["dist_to_mean"][-1].max() == 0.0


def test_cuda_generator_state_through_checkpointer(cuda, tmp_path):
    """A CUDA generator's state (its seed and Philox offset, the launcher's
    wire generator) saved and restored through the Checkpointer: the
    restored generator reports the same initial seed and draws the same
    next uniforms bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    gen = torch.Generator(device=cuda).manual_seed(1234)
    torch.rand((3, 1001), generator=gen, device=cuda)
    ck = Checkpointer(str(tmp_path), keep=1, fingerprint={"seed": 1234})
    ck.save(1, {"wire_gen": gen.get_state()}, block=False)
    want = torch.rand((4, 777), generator=gen, device=cuda)
    ck.wait()
    other = torch.Generator(device=cuda).manual_seed(7)
    torch.rand(5, generator=other, device=cuda)
    step, tree, _ = Checkpointer(str(tmp_path), fingerprint={
        "seed": 1234}).restore_latest({"wire_gen": other.get_state()})
    other.set_state(tree["wire_gen"])
    assert step == 1 and other.initial_seed() == 1234
    assert torch.equal(torch.rand((4, 777), generator=other, device=cuda),
                       want)


# --------------------------------------------------- the recurrent decoders


def _recurrent_cfg(arch):
    """The reduced recurrent decoders of tests/test_torch_archs.py:
    recurrentgemma-2b with its local attention layer (window 64), xlstm-1.3b
    with a (mLSTM, sLSTM) period."""
    import dataclasses

    from repro_torch.configs import get_config
    if arch == "recurrentgemma-2b":
        return get_config(arch).reduced(layers=3)
    cfg = get_config(arch).reduced()
    m = cfg.layer_period[0]
    return cfg.replace(layer_period=(m, dataclasses.replace(m,
                                                            mixer="slstm")))


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_recurrent_mixer_on_card_matches_cpu(cuda, kind):
    """Each mixer's train-mode forward and backward (every parameter and
    the input, of sum(y * w)) on the card against the same code on the
    CPU: y at 1e-4 (relative and absolute), each gradient at 1e-4 of
    max(1, its largest |entry|) (float32 products in other orders; the
    RG-LRU scan at S 37, not a power of two; the mLSTM's trailing partial
    chunk)."""
    from repro_torch.configs import get_config
    from repro_torch.models import recurrent as rec
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    arch = "recurrentgemma-2b" if kind == "rglru" else "xlstm-1.3b"
    cfg = get_config(arch).reduced()
    params = getattr(rec, f"init_{kind}")(torch.Generator().manual_seed(0),
                                          cfg, device="cpu")
    fwd = getattr(rec, f"{kind}_forward")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 37, cfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 37, cfg.d_model)).astype(
        np.float32))
    out = []
    for dev in ("cpu", cuda):
        leaves, skel = tree_flatten(params)
        leaves = [t.to(dev).requires_grad_(True) for t in leaves]
        xd = x.to(dev).requires_grad_(True)
        y, _ = fwd(tree_unflatten(skel, leaves), xd, cfg=cfg, mode="train")
        grads = torch.autograd.grad(torch.sum(y * w.to(dev)), leaves + [xd])
        out.append((y.detach().cpu(), [g.cpu() for g in grads]))
    (y_c, g_c), (y_g, g_g) = out
    torch.testing.assert_close(y_g, y_c, rtol=1e-4, atol=1e-4)
    for a, b in zip(g_g, g_c):
        assert bool(torch.all(torch.isfinite(a)))
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a / scale, b / scale, rtol=0.0, atol=1e-4)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_recurrent_decode_writes_the_stacked_state(cuda, arch):
    """On the card, decode writes each layer's recurrent state through the
    views of the stacked cache: every leaf keeps its storage, and after a
    prefill of 70 tokens (past the window of 64) and 3 decode steps the
    states and the last logits equal a prefill of the 73 tokens' at 1e-4
    (the scan against the one-step updates, float32)."""
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_flatten
    cfg = _recurrent_cfg(arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 73)).astype(np.int32)).to(cuda)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks[:, :70]},
                                  max_len=80)
        leaves = tree_flatten(caches)[0]
        ptrs = [t.data_ptr() for t in leaves]
        before = [t.clone() for t in leaves]
        for i in range(70, 73):
            logits, out = model.decode_step(params, caches,
                                            toks[:, i:i + 1], i)
            assert out is caches
        ref_logits, ref = model.prefill(params, {"tokens": toks},
                                        max_len=80)
    after = tree_flatten(caches)[0]
    assert [t.data_ptr() for t in after] == ptrs
    paths = tree_flatten(_key_tree(caches))[0]
    states = [i for i, p in enumerate(paths)
              if p.rsplit("/", 1)[-1] not in ("k", "v", "pos")]
    assert states
    for i in states:
        assert not torch.equal(after[i], before[i]), paths[i]
        torch.testing.assert_close(after[i], tree_flatten(ref)[0][i],
                                   rtol=1e-4, atol=1e-4, msg=paths[i])
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-4)


def _key_tree(tree, prefix=""):
    """The tree with each leaf replaced by its key path."""
    if isinstance(tree, dict):
        return {k: _key_tree(v, f"{prefix}/{k}") for k, v in tree.items()}
    return prefix


def test_merged_hybrid_served_on_card(cuda):
    """The reduced recurrentgemma-2b (RG-LRU, RG-LRU, local attention
    with window 64) trained on the card for 2 rounds of 2 agents (the
    last the final merge), merged, and served by the engine (3 slots,
    prompts of 70 and 81 tokens: the window's ring wraps): the rows
    identical after the merge, every request's greedy tokens equal to it
    generated alone, no id outside the vocabulary."""
    from repro_torch.core import merge as merge_mod
    from repro_torch.launch.train import sample_segment_batches
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.serving import Request, ServingEngine, generate
    cfg = _recurrent_cfg("recurrentgemma-2b")
    model = build_model(cfg)
    m, rounds, H = 2, 2, 2
    opt = make_optimizer("adamw", 3e-3, total_steps=rounds * H)
    state, spec = dsgd.init_panel_state(
        model.init_params, opt, m, torch.Generator(device=cuda).manual_seed(0),
        device=cuda)
    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = sample_segment_batches(
        lm, lm.domain_mixtures(m, 0.1, seed=1), rounds, H, 2, 32,
        np.random.default_rng(2))
    Ws = np.stack([np.eye(m), np.full((m, m), 1.0 / m)]).astype(np.float32)
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
    state, _ = seg(state, batches, Ws)
    x = state["panel"]["float32"]
    assert torch.equal(x, x[:1].expand_as(x))
    merged = merge_mod.merged_panel_tree(state["panel"], spec)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size,
                                               [70, 81][i % 2]).astype(
                                                   np.int32), max_new=8)
            for i in range(5)]
    out = ServingEngine(model, merged, max_concurrency=3,
                        max_len=96).serve(reqs)
    for r in reqs:
        assert ((out[r.rid] >= 0) & (out[r.rid] < cfg.vocab_size)).all()
        alone = generate(model, merged, {"tokens": torch.from_numpy(
            r.tokens[None]).to(cuda)}, r.max_new, max_len=96)[0]
        np.testing.assert_array_equal(out[r.rid], alone)


def test_native_quantize_of_a_block_on_the_card(cuda):
    """The kernel-drawn quantize of a block of a panel (row0, col0: a
    rank's shard) is that block of the whole panel's quantize and its
    plain twin's."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((6, 5000), generator=g, device=cuda)
    s = int8_scale_ref(x)
    seed = torch.tensor([991], dtype=torch.int32, device=cuda)
    whole = quantize_int8_native(x, s, seed)
    for r0, c0 in ((0, 2048), (2, 512), (5, 4608)):
        blk, sb = x[r0:, c0:].contiguous(), s[r0:].contiguous()
        q = quantize_int8_native(blk, sb, seed, row0=r0, col0=c0)
        assert torch.equal(q, whole[r0:, c0:])
        assert torch.equal(q, quantize_int8_native_ref(blk, sb, seed,
                                                       row0=r0, col0=c0))


def test_mesh_ranks_on_one_card_talk_through_cuda_ipc(cuda, tmp_path):
    """Four ranks of the (1, 2, 2, 1) mesh on the one card: their
    collectives go through the CUDA IPC buffers (a tensor over the buffer
    a buffer's worth at a time, never through host memory) and give
    gloo's results."""
    import _torch_dist
    from repro_torch.launch.mesh import IPC_BYTES
    _torch_dist.spawn(4, "ipc", tmp_path, timeout=180)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    base = torch.arange(6, dtype=torch.float32).view(2, 3)
    for r, o in enumerate(ranks):
        assert o["transport"] == "cuda ipc"
        rows, fsdp = o["members"][:2].tolist(), o["members"][2:].tolist()
        assert torch.equal(o["rows"], torch.cat([base + 10 * p
                                                 for p in rows]))
        assert torch.equal(o["fsdp"], torch.cat([base + 10 * p
                                                 for p in fsdp]))
        assert torch.equal(o["sum"], sum(base + 10 * p for p in rows))
        assert torch.equal(o["max"], base + 10 * max(fsdp))
        assert o["ints"].tolist() == [sum(p + 1 for p in fsdp)] * 3
        n = IPC_BYTES // 4 + 1
        whole = torch.cat([torch.full((n,), float(p)) for p in rows])
        whole[n - 1::n] = -torch.tensor(rows, dtype=torch.float32)
        assert torch.equal(o["big"], whole[::1 << 20])
        assert o["big_tail"].tolist() == [x for p in rows
                                          for x in (float(p), -float(p))]
        assert o["big_max"].tolist() == [float(max(fsdp)),
                                          -float(min(fsdp))]
        assert o["stats"]["stage"] == 0  # nothing went through the host

