"""The port's compressed gossip wire against the JAX package's.

Inputs are made with numpy from a seed and go through both packages:

* the plain versions of the wire kernels (``kernels/ref.py``) against the
  reference's oracles called outside ``jax.jit`` and against its Pallas
  kernels in interpret mode, as ``tests/test_kernels.py`` runs them:
  bitwise, over m in {4, 8} and D in {64, 333, 1001, 4096}, with an
  all-zero row and values placed exactly on half steps (ties to even);
* the codecs against ``repro.wire.codec``, with the reference's own
  uniforms fed to the port (``u=``): views, residuals and mirrors bitwise
  (the bf16 cast too), byte accounting against the real wire arrays; the
  codec path of the mix within 1e-6 (one bf16 ulp of the reference's rows
  under bf16, whose rounding follows a sum taken in another order);
* the engine rules of ``tests/test_wire_conformance.py`` (idle rows and
  idle rounds untouched bit for bit, a global merge collapses Xi), held on
  the port;
* the training segment at the verify recipe's size for ``topk``, ``bf16``
  and the round-to-nearest ``int8_ef`` and ``int4_ef``, against the jitted
  reference segment, at rtol 1e-4 as ``tests/test_torch_segment.py`` (20
  AdamW steps amplify float32 rounding; the two frameworks sum products in
  other orders).

The verify-size segment cases live in ``tests/test_torch_wire_segment.py``.
The int4 kernels' plain versions are held against the reference's in
``tests/test_torch_wire_int4.py``; the CUDA kernels themselves against the
plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.core import panel as ref_panel
from repro.core.topology import random_matching
from repro.kernels import ref as jref
from repro.kernels import wire_quant as jwq
from repro.wire import codec as ref_codec
from repro_torch import wire
from repro_torch.core import dsgd, panel
from repro_torch.kernels import ref as pref
from repro_torch.kernels import wire_quant as pwq
from repro_torch.merging import merge_panel
from repro_torch.optim import make_optimizer

SWEEP = [(m, D) for m in (4, 8) for D in (64, 333, 1001, 4096)]
NAMES = sorted(wire.CODECS)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np(a):
    """numpy view of a tensor; bfloat16 as JAX's numpy bfloat16."""
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view(jnp.bfloat16)
    return a.numpy()


def _same_bits(a, b):
    a = _np(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _quant_inputs(m, D, seed=0):
    """x (m, D) with row 1 all zero (scale 1/127) and row 2 on half steps:
    its amax is 127/64, so its scale is exactly 1/64 and x / s = k + 1/2
    exactly; u uniform in [0, 1)."""
    rng = np.random.default_rng(seed + 1000 * m + D)
    x = rng.standard_normal((m, D)).astype(np.float32)
    x[1] = 0.0
    k = rng.integers(-127, 127, size=D)
    x[2] = ((k + 0.5) / 64).astype(np.float32)
    x[2, 0] = 127 / 64
    return x, rng.random((m, D), dtype=np.float32)


# --------------------------------------------------------- plain versions


@pytest.mark.parametrize("stochastic", [False, True], ids=["rtn", "sr"])
@pytest.mark.parametrize("m,D", SWEEP)
def test_quantize_dequantize_match_oracles_and_pallas(m, D, stochastic):
    x, u = _quant_inputs(m, D)
    s = pref.int8_scale_ref(_t(x))
    js = jref.int8_scale_ref(_j(x))
    _same_bits(s.numpy(), js)
    assert float(s[1, 0]) == np.float32(1.0) / np.float32(127.0)
    assert float(s[2, 0]) == 1 / 64
    uu = u if stochastic else None
    q = pwq.quantize_int8(_t(x), s, None if uu is None else _t(uu))
    ju = None if uu is None else _j(uu)
    _same_bits(q.numpy(), jref.quantize_int8_ref(_j(x), js, ju))
    pq, _ = jwq.quantize_int8_panel(_j(x), js, ju, block_d=128,
                                    interpret=True)
    _same_bits(q.numpy(), pq)
    if not stochastic:  # every half step of row 2 went to the even side
        assert np.all(q.numpy()[2, 1:] % 2 == 0)
        assert np.all(q.numpy()[1] == 0)
    y = pwq.dequantize_int8(q, s)
    _same_bits(y.numpy(), jref.dequantize_int8_ref(_j(q.numpy()), js))
    _same_bits(y.numpy(), jwq.dequantize_int8_panel(
        _j(q.numpy()), js, block_d=128, interpret=True))


@pytest.mark.parametrize("m,D", SWEEP)
def test_topk_threshold_and_sparsify_match_oracles_and_pallas(m, D):
    rng = np.random.default_rng(m * 31 + D)
    x = rng.standard_normal((m, D)).astype(np.float32)
    x[1] = 0.0
    # row 3: magnitudes from a small set, so many entries tie with the
    # threshold (ties survive)
    x[3] = rng.choice(np.float32([-3, -2, -1, 1, 2, 3]), size=D)
    k = max(1, D // 8)
    t = pref.topk_threshold_ref(_t(x), k)
    assert t.is_contiguous()  # the CUDA wrapper takes contiguous rows only
    _same_bits(t.numpy(), jref.topk_threshold_ref(_j(x), k))
    y = pwq.sparsify_topk(_t(x), t)
    _same_bits(y.numpy(), jref.sparsify_topk_ref(_j(x), _j(t.numpy())))
    _same_bits(y.numpy(), jwq.sparsify_topk_panel(
        _j(x), _j(t.numpy()), block_d=128, interpret=True))
    kept = np.count_nonzero(y.numpy(), axis=1)
    assert kept[0] == k and kept[1] == 0
    assert kept[3] > k  # the ties at the threshold all survived


def test_wrappers_reject_other_devices():
    x = torch.zeros((2, 4), device="meta")
    s = torch.ones((2, 1), device="meta")
    for fn, args in ((pwq.quantize_int8, (x, s)),
                     (pwq.dequantize_int8, (x.to(torch.int8), s)),
                     (pwq.sparsify_topk, (x, s))):
        with pytest.raises(ValueError):
            fn(*args)


# ----------------------------------------------------------------- codecs


def _ref_twin(codec):
    """The reference codec with the same name and settings."""
    if isinstance(codec, wire.Int8Codec):
        return ref_codec.Int8Codec(codec.name, stochastic=codec.stochastic,
                                   error_feedback=codec.error_feedback)
    if isinstance(codec, wire.Int4Codec):
        return ref_codec.Int4Codec(codec.name, stochastic=codec.stochastic,
                                   error_feedback=codec.error_feedback,
                                   group=codec.group)
    if isinstance(codec, wire.DtypeCodec):
        return ref_codec.DtypeCodec(jnp.dtype(str(codec.wire_dtype).replace(
            "torch.", "")), codec.name)
    if isinstance(codec, wire.TopKCodec):
        return ref_codec.TopKCodec(codec.name, density=codec.density,
                                   gamma=codec.gamma,
                                   thresh_sample=codec.thresh_sample)
    return ref_codec.CODECS[codec.name]


@pytest.mark.parametrize("name", NAMES)
def test_registry_contract_matches_reference(name):
    codec = wire.get_codec(name)
    ref = ref_codec.get_codec(name)
    assert codec is wire.CODECS[name] and codec.name == name
    assert wire.get_codec(codec) is codec  # instance pass-through
    for attr in ("needs_key", "error_feedback", "delta_mix"):
        assert getattr(codec, attr) == getattr(ref, attr)
    for m, d in ((3, 257), (1, 237502464), (8, 1 << 24)):
        assert codec.payload_bytes(m, d, torch.float32) == \
            ref.payload_bytes(m, d, jnp.float32)
        assert codec.total_bytes(m, d, torch.float32) == \
            ref.total_bytes(m, d, jnp.float32)
    if name == "topk":
        assert codec.gamma == ref.gamma == 0.25


@pytest.mark.parametrize("name", ["bf16", "int4", "int4_ef"])
def test_later_codecs_raise(name):
    """Every codec of the reference's registry is in the port's (the
    codecs of this name once raised, waiting for their slice), resolves
    through ``with_wire``, and an unknown name still raises."""
    assert sorted(wire.CODECS) == sorted(ref_codec.CODECS)
    codec = wire.get_codec(name)
    assert type(codec).__name__ == type(ref_codec.CODECS[name]).__name__
    spec = panel.with_wire(panel.make_spec({"w": torch.zeros((2, 3))}),
                           name)
    assert spec.wire_of("float32") == name
    with pytest.raises(ValueError, match="unknown wire codec"):
        wire.get_codec(name + "x")


@pytest.mark.parametrize("name", NAMES)
def test_payload_bytes_match_encoded_size(name):
    codec = wire.get_codec(name)
    m, d = 3, 333
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (m, d)).astype(np.float32))
    err = (codec.init_err(torch.zeros_like(x)) if codec.error_feedback
           else None)
    payload, meta = codec.wire_payload(
        x, gen=torch.Generator().manual_seed(0), err=err)
    pb = sum(a.numel() * a.element_size() for a in payload)
    tb = pb + sum(a.numel() * a.element_size() for a in meta)
    assert pb == codec.payload_bytes(m, d, torch.float32)
    assert tb == codec.total_bytes(m, d, torch.float32)
    spec = panel.with_wire(panel.make_spec({"w": x}), name)
    ref_spec = ref_panel.with_wire(ref_panel.make_spec({"w": _j(x)}), name)
    assert spec.wire_payload_bytes == ref_spec.wire_payload_bytes == \
        codec.payload_bytes(1, d, "float32")
    assert spec.wire_total_bytes == ref_spec.wire_total_bytes == \
        codec.total_bytes(1, d, "float32")


CODEC_CASES = {
    "int8": wire.CODECS["int8"], "int8_ef": wire.CODECS["int8_ef"],
    "topk": wire.CODECS["topk"],
    "int8_rtn": wire.Int8Codec("int8", stochastic=False),
    "int8_ef_rtn": wire.Int8Codec("int8_ef", stochastic=False,
                                  error_feedback=True),
    # subsampled threshold: D = 1001 > 64 takes every 15th column
    "topk_sampled": wire.TopKCodec("topk", thresh_sample=64),
    "bf16": wire.CODECS["bf16"],
    "int4": wire.CODECS["int4"], "int4_ef": wire.CODECS["int4_ef"],
    "int4_rtn": wire.Int4Codec("int4", stochastic=False),
    "int4_ef_rtn": wire.Int4Codec("int4_ef", stochastic=False,
                                  error_feedback=True),
    "int4_g32": wire.Int4Codec("int4_ef", error_feedback=True, group=32),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
@pytest.mark.parametrize("m,D", [(4, 64), (5, 333), (8, 1001)])
def test_encode_matches_reference(case, m, D):
    """View, back(view) and the new residual or mirror, bitwise against
    the reference's eager encode, with the reference's uniforms."""
    codec = CODEC_CASES[case]
    ref = _ref_twin(codec)
    rng = np.random.default_rng(m * 13 + D)
    x = rng.standard_normal((m, D)).astype(np.float32)
    x[1] = 0.0
    if isinstance(codec, wire.TopKCodec):  # a mirror that lags the panel
        err = x + 0.3 * rng.standard_normal((m, D)).astype(np.float32)
    else:  # a residual of a quantization step's size
        err = (0.01 * rng.standard_normal((m, D))).astype(np.float32)
    key = jax.random.PRNGKey(4) if ref.needs_key else None
    u = (np.asarray(ref_codec._uniform(key, (m, D))) if ref.needs_key
         else None)
    r_view, r_back, r_err = ref.encode(_j(x), key=key, err=_j(err))
    view, back, new_err = codec.encode(
        _t(x), err=_t(err), u=None if u is None else _t(u))
    _same_bits(view, r_view)
    _same_bits(back(view), r_back(r_view))
    if new_err is None:
        assert r_err is None
    else:
        _same_bits(new_err, r_err)
    if isinstance(codec, wire.TopKCodec):
        _same_bits(codec._threshold(_t(x - err)).numpy(),
                   ref._threshold(_j(x - err)))
        _same_bits(codec.residual(_t(x), new_err).numpy(),
                   ref.residual(_j(x), r_err))


def test_topk_threshold_subsample_arithmetic():
    """Above THRESH_SAMPLE the threshold is the kk-th largest of every
    (D // sample)-th column, kk = max(1, int(cols * density))."""
    codec = wire.TopKCodec("topk", thresh_sample=100)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 1001)).astype(np.float32))
    sub = torch.abs(x[:, ::10])  # 1001 // 100 = 10 -> 101 columns
    want = torch.sort(sub, dim=1, descending=True).values[:, 11:12]
    assert torch.equal(codec._threshold(x), want)  # kk = int(101 / 8) = 12
    assert codec._threshold(x).is_contiguous()
    exact = wire.TopKCodec("topk", thresh_sample=1001)
    assert torch.equal(exact._threshold(x), pref.topk_threshold_ref(x, 125))


def test_init_err():
    x = torch.randn((3, 7), generator=torch.Generator().manual_seed(1))
    for name in ("int8", "int8_ef", "int4", "int4_ef"):
        e = wire.CODECS[name].init_err(x)
        assert e.dtype == torch.float32 and not torch.any(e)
    mirror = wire.CODECS["topk"].init_err(x)
    assert torch.equal(mirror, x) and mirror.data_ptr() != x.data_ptr()
    ref = np.asarray(ref_codec.CODECS["topk"].init_err(_j(x.numpy())))
    _same_bits(mirror.numpy(), ref)


def test_encode_contract():
    x = torch.randn((4, 64), generator=torch.Generator().manual_seed(2))
    for name in ("int8_ef", "int4_ef", "topk"):
        with pytest.raises(ValueError, match="err"):
            wire.CODECS[name].encode(x, gen=torch.Generator())
    for name in ("int8", "int4"):
        with pytest.raises(ValueError, match="Generator"):
            wire.CODECS[name].encode(x)
    # a residual-free codec passes err through and does not fold it in
    e0 = torch.full_like(x, 0.01)
    g = torch.Generator().manual_seed(0)
    a, _, e1 = wire.CODECS["int8"].encode(x, gen=g, err=e0)
    b, _, none = wire.CODECS["int8"].encode(
        x, gen=torch.Generator().manual_seed(0))
    assert e1 is e0 and none is None and torch.equal(a, b)


@pytest.mark.parametrize("name", ["int8_ef", "int4_ef", "topk"])
def test_ef_residual_bounded_and_telescoping(name):
    """As test_wire_conformance.py's EF contract: one encode never grows the
    residual beyond the carried signal, and over T encodes of a CONSTANT
    input the residual stays bounded while the late-window mean of the
    transmitted view converges to the input at the O(max residual / T)
    rate."""
    codec = wire.CODECS[name]
    m, d, T = 3, 48, 48
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (m, d)).astype(np.float32))
    err = codec.init_err(torch.zeros_like(x))  # cold: nonvacuous for topk
    gen = torch.Generator().manual_seed(2)
    res0 = codec.residual(x, err)
    _, _, e1 = codec.encode(x, gen=gen, err=err)
    carried = float(torch.max(torch.abs(x + res0))) + 1e-4
    assert float(torch.max(torch.abs(codec.residual(x, e1)))) <= \
        1.5 * carried
    xhats, max_res = [], 0.0
    for _ in range(T):
        xhat, _, err = codec.encode(x, gen=gen, err=err)
        xhats.append(xhat.clone())
        max_res = max(max_res,
                      float(torch.max(torch.abs(codec.residual(x, err)))))
    assert max_res <= 1.5 * float(torch.max(torch.abs(x))) + 1e-4
    late = torch.mean(torch.stack(xhats[T // 2:]), dim=0)
    gap = float(torch.max(torch.abs(late - x)))
    assert gap <= 6.0 * max_res / T + 1e-6, (gap, max_res)


@pytest.mark.parametrize("name", ["int8", "int8_ef", "int4", "int4_ef"])
def test_stochastic_rounding_unbiased(name):
    """E[xhat] == x within 6 empirical standard errors per element (plus a
    step/N slack for elements whose flip probability is O(1/N)), drawing
    from the port's own generator, as test_wire_conformance.py bounds the
    reference."""
    codec = wire.CODECS[name]
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (3, 40)).astype(np.float32))
    err = codec.init_err(x) if codec.error_feedback else None
    gen = torch.Generator().manual_seed(3)
    N = 256
    xh = torch.stack([codec.encode(x, gen=gen, err=err)[0]
                      for _ in range(N)])
    mean_err = torch.abs(torch.mean(xh, dim=0) - x)
    se = torch.std(xh, dim=0, correction=0) / np.sqrt(N)
    step = torch.amax(torch.amax(xh, 0) - torch.amin(xh, 0), dim=1,
                      keepdim=True)
    assert torch.all(mean_err <= 6.0 * se + 6.0 * step / N + 1e-7)
    assert torch.any(se > 0)  # the draws really differ


# ----------------------------------------------------------- engine rules


def _toy(dim=10, classes=3):
    def init_params(gen, device):
        return {"w": 0.1 * torch.randn((dim, classes), generator=gen,
                                       device=device),
                "b": torch.zeros((classes,), device=device)}

    def loss_fn(p, batch, rng=None):
        lg = batch["x"] @ p["w"] + p["b"]
        return torch.nn.functional.cross_entropy(lg, batch["y"]), {}

    return init_params, loss_fn


def _gen_for(codec, seed):
    return torch.Generator().manual_seed(seed) if codec.needs_key else None


@pytest.mark.parametrize("name", NAMES)
def test_idle_segment_bitexact(name):
    """A segment of W = I rounds sends nothing: every codec leaves panel,
    metrics and the error-feedback state exactly as the f32 run does."""
    m, H, S, dim, classes = 4, 2, 3, 10, 3
    init_params, loss_fn = _toy(dim, classes)
    rng = np.random.default_rng(0)
    batches = {"x": rng.standard_normal((S, H, m, 8, dim)).astype(
        np.float32), "y": rng.integers(0, classes, (S, H, m, 8))}
    Ws = np.stack([np.eye(m, dtype=np.float32)] * S)

    def run(wire_name):
        opt = make_optimizer("adamw", 1e-2)
        state, spec = dsgd.init_panel_state(init_params, opt, m, 0,
                                            device="cpu", wire=wire_name)
        err0 = {k: v.clone() for k, v in state.get("wire_err", {}).items()}
        seg = dsgd.make_panel_segment(loss_fn, opt, H, spec)
        return seg(state, batches, Ws, 1), err0

    (base, base_mets), _ = run(None)
    (out, mets), err0 = run(name)
    for k in base["panel"]:
        assert torch.equal(base["panel"][k], out["panel"][k])
    for k in ("loss", "consensus"):
        assert torch.equal(base_mets[k], mets[k])
    assert ("wire_err" in out) == wire.CODECS[name].error_feedback
    for k, v in out.get("wire_err", {}).items():
        assert torch.equal(v, err0[k])


@pytest.mark.parametrize("name", NAMES)
def test_idle_rows_exact_in_dense_mix(name):
    codec = wire.CODECS[name]
    m, d = 4, 64
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (m, d)).astype(np.float32))
    W = np.asarray([[0.5, 0.5, 0, 0], [0.5, 0.5, 0, 0], [0, 0, 1.0, 0],
                    [0, 0, 0, 1.0]], np.float32)
    spec = panel.with_wire(panel.make_spec({"w": x}), name)
    kw = dict(spec=spec, gen=_gen_for(codec, 8))
    if codec.error_feedback:
        err = codec.init_err(torch.zeros_like(x))
        out, new_err = panel.mix_dense({"float32": x}, W,
                                       err={"float32": err}, **kw)
        assert torch.equal(new_err["float32"][2:], err[2:])
    else:
        out = panel.mix_dense({"float32": x}, W, **kw)
    assert torch.equal(out["float32"][2:], x[2:])
    assert torch.any(out["float32"][:2] != x[:2])


@pytest.mark.parametrize("name", NAMES)
def test_global_merge_collapses_consensus(name):
    """global_merge and merge_panel leave every agent on one row through
    any codec, and so does the fully connected mix for every codec but the
    damped delta one (whose global rounds the segment sends to
    merge_panel). The mix's folded Xi is then 0, but under bf16: its rows
    are rounded through bf16 while the folded mean stays float32 (the
    reference's rule), so Xi measures that rounding — as the reference's
    does."""
    codec = wire.CODECS[name]
    m, d = 4, 52
    x = torch.from_numpy(np.random.default_rng(29).standard_normal(
        (m, d)).astype(np.float32))
    spec = panel.with_wire(panel.make_spec({"w": x}), name)
    err = {"float32": codec.init_err(x)} if codec.error_feedback else None
    gen = _gen_for(codec, 9)
    out = panel.global_merge({"float32": x}, spec=spec, gen=gen, err=err)
    merged = out[0] if err is not None else out
    assert float(panel.consensus_distance(merged)) == 0.0
    mixed, row, new_err = merge_panel({"float32": x}, "uniform", spec=spec,
                                      gen=gen, err=err)
    assert float(panel.consensus_distance(mixed)) == 0.0
    # the float32 row travels back in the payload dtype (bf16), as in the
    # reference
    want = (row["float32"].to(torch.bfloat16).float() if name == "bf16"
            else row["float32"])
    assert torch.equal(mixed["float32"][0], want)
    if codec.delta_mix:  # full bandwidth: the exact mean, mirror reset
        assert torch.equal(row["float32"], panel.merged({"float32": x})[
            "float32"])
        assert torch.equal(new_err["float32"], mixed["float32"])
        assert new_err["float32"].data_ptr() != mixed["float32"].data_ptr()
        return
    full = np.full((m, m), 1.0 / m, np.float32)
    mixed, mean, _ = panel.mix_dense_mean({"float32": x}, full, spec=spec,
                                          gen=gen, err=err)
    y = mixed["float32"]
    assert torch.equal(y, y[:1].expand_as(y))
    xi = float(panel.consensus_from_mean(mixed, mean))
    if name != "bf16":
        assert xi == 0.0
        return
    ref_spec = ref_panel.with_wire(ref_panel.make_spec({"w": _j(x)}), name)
    r_mixed, r_mean, _ = ref_panel.mix_dense_mean({"float32": _j(x)},
                                                  _j(full), spec=ref_spec)
    r_xi = float(ref_panel.consensus_from_mean(r_mixed, r_mean))
    # the rounding of one bf16 row: at most half an ulp (2^-9 relative)
    assert 0.0 < xi <= 2.0 ** -9 * float(torch.linalg.vector_norm(
        mean["float32"]))
    np.testing.assert_allclose(xi, r_xi, rtol=1e-5)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    _, e = np.frexp(np.abs(v))
    return np.ldexp(np.float32(1.0), e - 8)


@pytest.mark.parametrize("case", ["topk", "int8_ef_rtn", "int8_rtn",
                                  "int4_ef_rtn", "int4_rtn", "bf16"])
def test_mix_dense_mean_matches_reference(case):
    """The codec path of the mix against the reference's eager mix, on a
    random matching with idle rows: the encoded payload is bit-identical,
    the mix sums in another order (1e-6). Under bf16 the mixed rows are
    then rounded through bf16, so a sum an f32 ulp apart can land one bf16
    ulp apart: the rows agree within one bf16 ulp, the float32 mean within
    1e-6."""
    codec = CODEC_CASES[case]
    ref = _ref_twin(codec)
    m, d = 8, 1001
    rng = np.random.default_rng(31)
    x = rng.standard_normal((m, d)).astype(np.float32)
    err = (x + 0.3 * rng.standard_normal((m, d)).astype(np.float32)
           if codec.delta_mix else
           (0.01 * rng.standard_normal((m, d))).astype(np.float32))
    W = random_matching(m, 0.6, np.random.default_rng(1)).astype(np.float32)
    assert any(W[r, r] == 1.0 for r in range(m))  # some rows are idle
    spec = panel.with_wire(panel.make_spec({"w": _t(x)}),
                           {"float32": codec})
    ref_spec = ref_panel.with_wire(ref_panel.make_spec({"w": _j(x)}),
                                   {"float32": ref})
    kw = {"err": {"float32": _t(err)}} if codec.error_feedback else {}
    rkw = {"err": {"float32": _j(err)}} if ref.error_feedback else {}
    mixed, mean, ne = panel.mix_dense_mean({"float32": _t(x)}, W, spec=spec,
                                           **kw)
    r_mixed, r_mean, r_ne = ref_panel.mix_dense_mean(
        {"float32": _j(x)}, _j(W), spec=ref_spec, **rkw)
    pairs = [(mean, r_mean)]
    if case == "bf16":
        got, want = mixed["float32"].numpy(), np.asarray(r_mixed["float32"])
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
        assert np.mean(got != want) <= 1e-2
    else:
        pairs.append((mixed, r_mixed))
    for got, want in pairs:
        np.testing.assert_allclose(got["float32"].numpy(),
                                   np.asarray(want["float32"]), atol=1e-6,
                                   rtol=1e-6)
    if codec.error_feedback:
        _same_bits(ne["float32"].numpy(), r_ne["float32"])
    np.testing.assert_allclose(
        float(panel.consensus_from_mean(mixed, mean)),
        float(ref_panel.consensus_from_mean(r_mixed, r_mean)), rtol=1e-5)
