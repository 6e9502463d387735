"""The on-chip-seeded stochastic int8 quantize (``quantize_int8_native``,
the port of ``quantize_int8_panel_native``) and its codec route.

The kernel cannot give the TPU's bits (``pltpu.prng_random_bits`` is
unspecified), so it is held in three ways:

* its plain twin's generator, Philox4x32-10, against the published
  known-answer vectors (Random123's ``kat_vectors``, Salmon et al.,
  SC'11), and the 64-bit-safe high/low product against exact integers;
* the twin's uniforms, fed to the reference's portable
  ``quantize_int8_panel(x, s, u=...)`` in interpret mode, give the twin's
  q bit for bit: the semantics are the reference's, the draws the only
  difference;
* the draws statistically, as ``tests/test_wire_props.py`` holds the
  reference's: unbiased over seeds, the rounding's support, and
  independence of (seed t, block i) from (seed t + 1, block i - 1) and
  (seed t, block i + 1) (the aliasing the two-word key guards against).

The codec route (``Int8Codec(draws="kernel")``) is held on the CPU through
the segment. The kernel is held against its twin on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.kernels import wire_quant as jwq
from repro_torch import wire
from repro_torch.core import dsgd, topology
from repro_torch.kernels import ref as pref
from repro_torch.kernels import wire_quant as pwq
from repro_torch.optim import make_optimizer
from repro_torch.wire import codec as codec_mod

# Random123 kat_vectors, philox4x32 10: (counter, key, output)
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
WIDTHS = (1, 3, 511, 513, 4097)


def _panel(m, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    x[0, : min(d, 7)] = 0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("ctr,key,out", KAT)
def test_philox_known_answer_vectors(ctr, key, out):
    got = pref.philox4x32_ref(key, ctr)
    assert [int(w) for w in got] == list(out)


def test_mulhilo_is_the_exact_64_bit_product():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 2000, dtype=np.uint64)
    a[:3] = [0, 1, 2 ** 32 - 1]
    for b in pref.PHILOX_M + (0xFFFFFFFF, 1):
        hi, lo = pref._mulhilo32(torch.from_numpy(a.astype(np.int64)), b)
        want = [int(x) * b for x in a]
        assert hi.tolist() == [w >> 32 for w in want]
        assert lo.tolist() == [w & 0xFFFFFFFF for w in want]


def test_native_uniforms_layout_and_chunks():
    """Column c of row r is word c % 4 of Philox4x32-10 on key (seed,
    c // 512) and counter (r, (c % 512) // 4, 0, 0), its low 24 bits over
    2^24; a column range gives the same numbers as the whole row; the
    seed's bits are read as a uint32."""
    m, D, seed = 3, 2051, -123456789
    u = pref.native_uniforms_ref(seed, m, D)
    assert u.shape == (m, D) and u.dtype == torch.float32
    for r, c in ((0, 0), (1, 5), (2, 511), (0, 512), (2, 1027), (1, 2050)):
        w = pref.philox4x32_ref((seed & 0xFFFFFFFF, c // 512),
                                (r, (c % 512) // 4, 0, 0))[c % 4]
        assert float(u[r, c]) == float(int(w) & 0xFFFFFF) / 2 ** 24
    part = pref.native_uniforms_ref(seed, m, D, lo=1024, hi=1540)
    assert torch.equal(part, u[:, 1024:1540])
    t = torch.tensor([seed], dtype=torch.int32)
    assert torch.equal(pref.native_uniforms_ref(t, m, D), u)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


@pytest.mark.parametrize("D", WIDTHS)
def test_native_twin_through_reference_quantize(D):
    """The twin's uniforms through the reference's quantize_int8_panel(u=)
    (Pallas, interpret mode) give the twin's q bit for bit; chunking does
    not change it."""
    m = 5
    x = _panel(m, D, D)
    s = pref.int8_scale_ref(x)
    seed = torch.tensor([2 ** 31 - 7], dtype=torch.int32)
    q = pwq.quantize_int8_native(x, s, seed)
    u = pref.native_uniforms_ref(seed, m, D)
    rq, _ = jwq.quantize_int8_panel(jnp.asarray(x.numpy()),
                                    jnp.asarray(s.numpy()),
                                    jnp.asarray(u.numpy()), interpret=True)
    assert q.dtype == torch.int8
    assert q.numpy().tobytes() == np.asarray(rq).tobytes()
    assert torch.equal(pref.quantize_int8_native_ref(x, s, seed, chunk=512),
                       q)


def test_native_quantize_is_unbiased_over_seeds():
    """E[q s] = x: over 400 seeds the mean of dequant(quant(x)) is within
    6 standard errors (of the per-element rounding variance, at most
    s^2 / 4) of x, per element."""
    m, D, n = 3, 700, 400
    x = _panel(m, D, 1)
    s = pref.int8_scale_ref(x)
    acc = torch.zeros((m, D), dtype=torch.float64)
    for t in range(n):
        q = pref.quantize_int8_native_ref(x, s, t)
        acc += (q.double() * s.double())
    dev = (acc / n - x.double()).abs()
    assert bool(torch.all(dev <= 6 * 0.5 * s.double() / np.sqrt(n)))
    assert float(dev.mean()) < 0.1 * float(s.mean())


@pytest.mark.parametrize("D", WIDTHS)
def test_native_quantize_support(D):
    """q is floor(x / s) or floor(x / s) + 1, after the clip to +-127."""
    m = 4
    x = _panel(m, D, 2) * 3.0
    s = pref.int8_scale_ref(x)
    lo = torch.floor(x / s)
    for t in range(5):
        q = pref.quantize_int8_native_ref(x, s, t).to(torch.float32)
        ok = (q == torch.clamp(lo, -127, 127)) | (
            q == torch.clamp(lo + 1, -127, 127))
        assert bool(torch.all(ok))


def _corr(a, b):
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))


def test_blocks_and_seeds_draw_independent_streams():
    """(seed t, block i) against (seed t + 1, block i - 1) and against
    (seed t, block i + 1): the streams are not copies and are uncorrelated
    (|r| under 5 / sqrt(n)). A single-word key seed + block would alias
    the first pair exactly, as the control shows."""
    m, blocks = 4, 6
    pairs_seed, pairs_block = [], []
    for t in range(8):
        u = pref.native_uniforms_ref(t, m, 512 * blocks)
        v = pref.native_uniforms_ref(t + 1, m, 512 * blocks)
        for i in range(1, blocks - 1):
            a = u[:, 512 * i:512 * (i + 1)]
            pairs_seed.append((a, v[:, 512 * (i - 1):512 * i]))
            pairs_block.append((a, u[:, 512 * (i + 1):512 * (i + 2)]))
    for pairs in (pairs_seed, pairs_block):
        a = torch.cat([p[0].reshape(-1) for p in pairs]).double()
        b = torch.cat([p[1].reshape(-1) for p in pairs]).double()
        assert not any(torch.equal(p, q) for p, q in pairs)
        assert abs(_corr(a, b)) < 5 / np.sqrt(a.numel())

    def one_word(seed, block):  # the keying the reference rules out
        w = pref.philox4x32_ref((seed + block, 0),
                                (0, torch.arange(128), 0, 0))
        return torch.stack(w, -1)
    assert torch.equal(one_word(3, 2), one_word(4, 1))
    assert not torch.equal(
        pref.native_uniforms_ref(3, 1, 1536)[:, 1024:],
        pref.native_uniforms_ref(4, 1, 1536)[:, 512:1024])


def test_native_quantize_checks_its_seed_and_the_wrapper_runs_the_twin():
    x = _panel(2, 9, 3)
    s = pref.int8_scale_ref(x)
    seed = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(pwq.quantize_int8_native(x, s, seed),
                       pref.quantize_int8_native_ref(x, s, 5))
    assert pwq.quantize_int8_native.launches == 0  # the CPU runs no kernel
    with pytest.raises(ValueError):
        pwq.quantize_int8_native(x.to("meta"), s.to("meta"),
                                 seed.to("meta"))


# -------------------------------------------------------------- the codec


def test_kernel_draws_codec_route(monkeypatch):
    """draws="kernel": one int32 seed drawn from gen a call, the quantize
    through quantize_int8_native, never the supplied-uniform quantize (no
    uniform panel); the result equals the twin on that seed; u= is refused,
    gen is required; wire_payload follows the same route."""
    calls = {"native": 0, "plain": 0}
    real_native, real_plain = codec_mod.quantize_int8_native, \
        codec_mod.quantize_int8

    def native(*a):
        calls["native"] += 1
        return real_native(*a)

    def plain(*a):
        calls["plain"] += 1
        return real_plain(*a)

    monkeypatch.setattr(codec_mod, "quantize_int8_native", native)
    monkeypatch.setattr(codec_mod, "quantize_int8", plain)
    c = wire.Int8Codec("int8_ef", error_feedback=True, draws="kernel")
    assert c.needs_key and c.error_feedback
    x = _panel(4, 1001, 4)
    e = 0.01 * _panel(4, 1001, 5)
    g = torch.Generator().manual_seed(9)
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,),
                         generator=torch.Generator().manual_seed(9),
                         dtype=torch.int32)
    view, _, ne = c.encode(x, gen=g, err=e)
    x32 = x + e
    s = pref.int8_scale_ref(x32)
    want = pref.quantize_int8_native_ref(x32, s, seed).float() * s
    assert torch.equal(view, want) and torch.equal(ne, x32 - want)
    payload, meta = c.wire_payload(x, gen=g, err=e)
    assert payload[0].dtype == torch.int8 and meta[0].shape == (4, 1)
    assert calls == {"native": 2, "plain": 0}
    with pytest.raises(ValueError, match="u="):
        c.encode(x, err=e, gen=g, u=torch.zeros_like(x))
    with pytest.raises(ValueError, match="Generator"):
        c.encode(x, err=e)
    with pytest.raises(ValueError, match="draws"):
        wire.Int8Codec("int8", draws="device")
    rtn = wire.Int8Codec("int8", stochastic=False, draws="kernel")
    assert torch.equal(rtn.encode(x)[0], wire.Int8Codec(
        "int8", stochastic=False).encode(x)[0])


def test_kernel_draws_codec_in_the_segment():
    """int8_ef with the kernel's draws through a segment (the codec given
    as an instance to the spec's wire policy): finite losses, rows
    identical and Xi 0 after the final merge, the residual carried."""
    m, S, dim, classes = 4, 3, 10, 3

    def init_params(gen, device):
        return {"w": 0.1 * torch.randn((dim, classes), generator=gen,
                                       device=device),
                "b": torch.zeros((classes,), device=device)}

    def loss_fn(p, batch, rng=None):
        lg = batch["x"] @ p["w"] + p["b"]
        return torch.nn.functional.cross_entropy(lg, batch["y"]), {}

    opt = make_optimizer("adamw", 1e-2)
    codec = wire.Int8Codec("int8_ef", error_feedback=True, draws="kernel")
    state, spec = dsgd.init_panel_state(init_params, opt, m, 0,
                                        device="cpu", wire=codec)
    assert spec.wire_of("float32") is codec
    rng = np.random.default_rng(0)
    Ws = np.stack([topology.random_matching(m, 1.0, rng) for _ in range(2)]
                  + [topology.fully_connected(m)]).astype(np.float32)
    batches = {"x": rng.standard_normal((S, 2, m, 8, dim)).astype(np.float32),
               "y": rng.integers(0, classes, (S, 2, m, 8))}
    seg = dsgd.make_panel_segment(loss_fn, opt, 2, spec)
    out, mets = seg(state, batches, Ws, 1)
    x = out["panel"]["float32"]
    assert torch.equal(x, x[:1].expand_as(x))
    assert float(mets["consensus"][-1]) == 0.0
    assert np.all(np.isfinite(mets["loss"].numpy()))
    assert torch.any(out["wire_err"]["float32"] != 0)
