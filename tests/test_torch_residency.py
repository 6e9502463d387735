"""The port's storage residency against the JAX package's.

Inputs are made with numpy from a seed and go through both packages:

* the storage contract (``repro_torch.residency``, the counterpart of
  ``tests/test_residency_conformance.py``): registry, parse-time errors,
  ``resident_bytes`` equal to the stored tensors' bytes, ``write`` raising
  without ``gen``/``u`` exactly when stochastic, ``zero_like`` and
  ``zeros`` equal to ``init(zeros)``, the round trip within half a step
  in the transform domain, stochastic rounding unbiased there, a single
  group equal to the per-row layout;
* every storage's ``init``/``write``/``read`` against the reference's on
  the same input and the reference's uniforms, bit for bit;
* the plain grouped int8 quantize and dequantize against the reference's
  oracles and its Pallas kernels in interpret mode (bit for bit);
* the plain fused AdamW step against the reference's Pallas kernel
  (interpret, under ``jax.jit``) on handed-over stored moments and the
  reference's uniforms: p within 1e-6 and the scales within 1e-6
  relative (XLA's jitted division and fused multiply-adds round an ulp
  apart from PyTorch's), q equal but for single-step differences on at
  most 0.5 % of entries;
* the byte models and the fused-update predicate against the reference's;
* the segment: fused equal to unfused bit for bit, an f32 policy byte for
  byte no policy, every quantized moment storage within the reference's
  0.05 loss bound of the f32 run, the random streams (fresh every step,
  none for f32/bf16, the wire codec's draws untouched), the idle-row rule
  of the stored error-feedback panel, ``decode_stats``;
* the launcher with ``--residency moments=int8`` on the CPU.

The kernels themselves are held against these plain versions on the card
in ``tests/test_torch_cuda.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro import residency as ref_res
from repro.core import panel as ref_panel
from repro.kernels import opt_fused as jof
from repro.kernels import ref as jref
from repro.kernels import wire_quant as jwq
from repro.optim import make_optimizer as ref_make_optimizer
from repro.telemetry import metrics as ref_metrics
from repro.wire.codec import _uniform
from repro_torch import merging, residency
from repro_torch.core import dsgd, panel
from repro_torch.kernels import ref as pref
from repro_torch.kernels import wire_quant as pwq
from repro_torch.kernels.opt_fused import adamw_fused_int8
from repro_torch.launch import train
from repro_torch.optim import make_optimizer
from repro_torch.telemetry import metrics
from repro_torch.weights import stored_from_reference

NAMES = sorted(residency.STORAGE)
STOCHASTIC = [n for n in NAMES if residency.STORAGE[n].needs_key]
GROUPED = [n for n in NAMES if residency.STORAGE[n].fused_update]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(a, b):
    """Two stored forms (tensors, arrays or {q, scale} dicts) bit for
    bit."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
        return
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def _moment_panel(m, d, seed):
    """Adam-v-like panel: positive, wide dynamic range."""
    rng = np.random.default_rng(seed)
    return (np.square(rng.normal(size=(m, d))) * np.exp(
        rng.normal(size=(m, d)) * 2.0) * 1e-4).astype(np.float32)


def _signed_panel(m, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, d)) * 1e-2).astype(np.float32)
    x[1, :40] = 0.0  # an all-zero group
    return x


def _nbytes(stored):
    if isinstance(stored, dict):
        return sum(v.numel() * v.element_size() for v in stored.values())
    return stored.numel() * stored.element_size()


# ---------------------------------------------------------- the contract


@pytest.mark.parametrize("name", NAMES)
def test_registry_contract(name):
    st = residency.get_storage(name)
    assert st is residency.STORAGE[name] and st.name == name
    assert residency.get_storage(st) is st
    ref = ref_res.get_storage(name)
    assert (st.needs_key, st.fused_update) == (ref.needs_key,
                                               ref.fused_update)
    assert st.resident_bytes(3, 257) == ref.resident_bytes(3, 257)
    assert st.resident_bytes(6, 257) == 2 * st.resident_bytes(3, 257)


def test_unknown_storage_and_kind_fail_at_parse_time():
    for mod in (residency, ref_res):
        with pytest.raises(ValueError, match="unknown storage"):
            mod.get_storage("int7")
        with pytest.raises(ValueError, match="unknown state kinds"):
            mod.parse_policy("params=int8")
        with pytest.raises(ValueError, match="unknown storage"):
            mod.parse_policy("moments=int7")
        assert mod.parse_policy(None) == {}
        assert mod.parse_policy("int8") == {"moments": "int8"}
        assert mod.parse_policy("moments=int8, stats=bf16") == {
            "moments": "int8", "stats": "bf16"}
    with pytest.raises(ValueError, match="transform"):
        residency.Int8Storage("x", group=8, transform="log")


@pytest.mark.parametrize("name", NAMES)
def test_resident_bytes_match_stored_nbytes(name):
    st = residency.get_storage(name)
    stored = st.init(_t(_moment_panel(3, 333, 5)))
    assert _nbytes(stored) == st.resident_bytes(3, 333)
    spec = panel.with_residency(panel.make_spec(
        {"w": torch.zeros((1, 333))}), {"moments": name})
    assert spec.storage_bytes("moments") == st.resident_bytes(1, 333)
    if name == "f32":
        assert spec.residency == ()


@pytest.mark.parametrize("name", NAMES)
def test_write_requires_gen_or_u_iff_stochastic(name):
    st = residency.get_storage(name)
    x = _t(_moment_panel(2, 64, 7))
    if st.needs_key:
        with pytest.raises(ValueError, match="stochastic"):
            st.write(x)
        a = st.write(x, gen=torch.Generator().manual_seed(0))
        b = st.write(x, u=torch.rand(x.shape, generator=torch.Generator()
                                     .manual_seed(0)))
        _same(a, b)  # a single slab: the same draw
    else:
        _same(st.write(x), st.write(x, gen=torch.Generator()))


@pytest.mark.parametrize("name", NAMES)
def test_zero_like_and_zeros_are_init_zeros(name):
    st = residency.get_storage(name)
    z = st.init(torch.zeros((3, 300)))
    stored = st.init(_t(_moment_panel(3, 300, 9)))
    _same(st.zero_like(stored), z)
    _same(st.zeros(3, 300, "cpu"), z)
    assert float(torch.max(torch.abs(st.read(z)))) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_roundtrip_bounded_in_transform_domain(name):
    st = residency.get_storage(name)
    x = _t(_moment_panel(4, 320, 11))
    stored = st.init(x)
    back = st.read(stored)
    assert back.dtype == torch.float32
    err = torch.abs(st.transform_fwd(back) - st.transform_fwd(x))
    if isinstance(stored, dict):
        g = st.group or x.shape[1]
        step = pref.expand_group_scale(stored["scale"], x.shape[1], g)
        assert bool(torch.all(err <= 0.5 * step * (1 + 1e-5) + 1e-12))
    else:
        eps = torch.finfo(stored.dtype).eps
        assert bool(torch.all(err <= 0.5 * eps * torch.abs(
            st.transform_fwd(x)) + 1e-12))
    assert st.maybe_read(back) is back
    _same(st.maybe_read(stored), back)


@pytest.mark.parametrize("name", STOCHASTIC)
def test_stochastic_unbiased_in_transform_domain(name):
    """E[decode] == x within 6 standard errors per element in the
    transform domain, as the reference's conformance test holds it."""
    st = residency.get_storage(name)
    x = _t(_moment_panel(3, 40, 13))
    y = st.transform_fwd(x)
    gen = torch.Generator().manual_seed(3)
    N = 256
    yh = torch.stack([st.transform_fwd(st.read(st.write(x, gen=gen)))
                      for _ in range(N)])
    mean_err = torch.abs(yh.mean(0) - y)
    se = yh.std(0) / np.sqrt(N)
    step = (yh.max(0).values - yh.min(0).values).max(1, keepdim=True).values
    assert bool(torch.all(mean_err <= 6.0 * se + 6.0 * step / N + 1e-7))


def test_grouped_single_group_matches_per_row():
    x = _t(_moment_panel(3, 200, 21))
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(5))
    a = residency.Int8Storage("a").write(x, u=u)
    b = residency.Int8Storage("b", group=512).write(x, u=u)
    assert a["scale"].shape == b["scale"].shape == (3, 1)
    _same(a, b)


# ------------------------------------------- against the reference's codec


@pytest.mark.parametrize("d", [333, 1001])
@pytest.mark.parametrize("name", NAMES)
def test_storage_matches_reference(name, d):
    st, ref = residency.get_storage(name), ref_res.get_storage(name)
    for x in (_moment_panel(4, d, 23), _signed_panel(4, d, 24)):
        _same(st.init(_t(x)), ref.init(jnp.asarray(x)))
        key = jax.random.PRNGKey(d)
        if st.needs_key:
            u = _t(_uniform(key, x.shape))
            got = st.write(_t(x), u=u)
        else:
            got = st.write(_t(x))
        want = ref.write(jnp.asarray(x), key=key)
        _same(got, want)
        # the reference's stored form, handed over, decodes to its read
        handed = stored_from_reference(jax.tree.map(np.asarray, want),
                                       device="cpu")
        _same(handed, got)
        _same(st.read(handed), ref.read(want))


def test_stored_from_reference_checks_the_form():
    with pytest.raises(ValueError, match="q and scale"):
        stored_from_reference({"q": np.zeros((2, 3), np.int8)}, "cpu")
    with pytest.raises(ValueError, match="stored int8"):
        stored_from_reference({"q": np.zeros((2, 3), np.float32),
                               "scale": np.ones((2, 1), np.float32)}, "cpu")


# ------------------------------------------- the grouped int8 plain pair

GQ_CASES = [(m, d, g) for d in (333, 1000, 1001) for g in (32, 128)
            for m in (3,)]


@pytest.mark.parametrize("m,D,group", GQ_CASES)
def test_grouped_int8_plain_matches_oracle_and_pallas(m, D, group):
    x = _signed_panel(m, D, D + group)
    x[2] = ((np.random.default_rng(0).integers(-127, 127, size=D) + 0.5)
            / 64).astype(np.float32)
    x[2, ::group] = 127 / 64  # every group's scale is 1/64: exact ties
    s = pref.int8_group_scale_ref(_t(x), group)
    _same(s, jref.int8_group_scale_ref(jnp.asarray(x), group))
    assert torch.all(s[2] == 1 / 64)
    js = jnp.asarray(s.numpy())
    u = np.asarray(_uniform(jax.random.PRNGKey(m + D), (m, D)))
    for uu in (None, u):
        ju = None if uu is None else jnp.asarray(uu)
        q = pwq.quantize_int8_grouped(_t(x), s, None if uu is None
                                      else _t(uu), group)
        _same(q, jref.quantize_int8_grouped_ref(jnp.asarray(x), js, ju,
                                                group))
        pq, _ = jwq.quantize_int8_grouped_panel(
            jnp.asarray(x), js, ju, group=group, block_d=256,
            interpret=True)
        _same(q, pq)
        if uu is None:  # ties to even
            ties = np.ones(D, bool)
            ties[::group] = False
            assert np.all(q.numpy()[2][ties] % 2 == 0)
        y = pwq.dequantize_int8_grouped(q, s, group)
        _same(y, jref.dequantize_int8_grouped_ref(jnp.asarray(q.numpy()),
                                                  js, group))
        _same(y, jwq.dequantize_int8_grouped_panel(
            jnp.asarray(q.numpy()), js, group=group, block_d=256,
            interpret=True))
    # a slab of whole groups of a wider panel, in place through out=
    out = torch.zeros((m, D), dtype=torch.int8)
    lo = group
    pwq.quantize_int8_grouped(_t(x)[:, lo:], s[:, 1:], _t(u)[:, lo:], group,
                              out=out[:, lo:])
    full = pwq.quantize_int8_grouped(_t(x), s, _t(u), group)
    _same(out[:, lo:], full[:, lo:])


# ------------------------------------------------- the fused AdamW step


def _fused_inputs(name, m, d, seed=30):
    st = ref_res.get_storage(name)
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(m, d)) * 0.1).astype(np.float32)
    p = rng.normal(size=(m, d)).astype(np.float32)
    mst = st.init(jnp.asarray(_signed_panel(m, d, seed + 1)))
    vst = st.init(jnp.asarray(_moment_panel(m, d, seed + 2)))
    um = np.asarray(_uniform(jax.random.PRNGKey(7), (m, d)))
    uv = np.asarray(_uniform(jax.random.PRNGKey(8), (m, d)))
    return st, g, p, mst, vst, um, uv


@pytest.mark.parametrize("d", [256, 333, 1001])
@pytest.mark.parametrize("name", GROUPED)
def test_fused_plain_matches_reference_kernel(name, d):
    m = 3
    st, g, p, mst, vst, um, uv = _fused_inputs(name, m, d)
    ref_opt = ref_make_optimizer("adamw", 1e-2)
    opt = make_optimizer("adamw", 1e-2)
    # rows at different step counts: per-agent bias corrections
    lr, bc1, bc2 = ref_opt.hyper(jnp.asarray([1, 7, 3]))
    fn = functools.partial(
        jof.adamw_fused_int8_panel, group=st.group, core=ref_opt.core,
        transform_fwd=st.transform_fwd, transform_inv=st.transform_inv,
        interpret=True)
    want = [np.asarray(a) for a in jax.jit(fn)(
        jnp.asarray(g), jnp.asarray(p), mst["q"], mst["scale"], vst["q"],
        vst["scale"], jnp.asarray(um), jnp.asarray(uv), lr, bc1, bc2)]
    ms, vs = (stored_from_reference(jax.tree.map(np.asarray, a), "cpu")
              for a in (mst, vst))
    cols = [_t(np.broadcast_to(np.asarray(a, np.float32).reshape(-1, 1),
                               (m, 1))) for a in (lr, bc1, bc2)]
    got = pref.adamw_fused_int8_ref(
        _t(g), _t(p), ms["q"], ms["scale"], vs["q"], vs["scale"], _t(um),
        _t(uv), *cols, group=st.group, transform=st.transform,
        **opt.hparams)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-6)
    diff = 0
    for q, s, wq, ws in ((got[1], got[2], want[1], want[2]),
                         (got[3], got[4], want[3], want[4])):
        np.testing.assert_allclose(s.numpy(), ws, rtol=1e-6, atol=0)
        dq = np.abs(q.numpy().astype(int) - wq.astype(int))
        assert dq.max() <= 1
        diff += int(np.count_nonzero(dq))
    share = diff / (2 * m * d)
    print(f"{name} d={d}: q entries one step apart {share:.4%}")
    assert share <= 0.005
    # the wrapper on CPU tensors: the plain version, written in place
    args = [_t(g), _t(p), ms["q"].clone(), ms["scale"].clone(),
            vs["q"].clone(), vs["scale"].clone(), _t(um), _t(uv)]
    out = adamw_fused_int8(*args, *cols, group=st.group,
                           transform=st.transform, **opt.hparams)
    assert all(a is b for a, b in zip(out, [args[1]] + args[2:6]))
    for a, b in zip(out, got):
        _same(a, b)


def test_fused_plain_is_the_unfused_composition():
    """decode (Storage.read) -> optim core -> encode (Storage.write) on
    the same uniforms gives the fused plain version's bits."""
    st = residency.get_storage("int8")
    m, d = 3, 333
    rng = np.random.default_rng(3)
    g, p = (_t(rng.normal(size=(m, d)).astype(np.float32)) for _ in "gp")
    ms, vs = (st.init(_t(_signed_panel(m, d, 4))),
              st.init(_t(_moment_panel(m, d, 5))))
    um, uv = (torch.rand((m, d), generator=torch.Generator().manual_seed(i))
              for i in (1, 2))
    opt = make_optimizer("adamw", 1e-2)
    lr, bc1, bc2 = opt.hyper(3)
    p2, m2, v2 = opt.core(g, st.read(ms), st.read(vs), p.clone(), lr=lr,
                          bc1=bc1, bc2=bc2)
    fused = pref.adamw_fused_int8_ref(
        g, p, ms["q"], ms["scale"], vs["q"], vs["scale"], um, uv,
        *(a.reshape(1, 1).expand(m, 1) for a in (lr, bc1, bc2)),
        group=128, transform="sqrt", **opt.hparams)
    _same(fused[0], p2)
    _same({"q": fused[1], "scale": fused[2]}, st.write(m2, u=um))
    _same({"q": fused[3], "scale": fused[4]}, st.write(v2, u=uv))


# ------------------------------------------- byte models and the predicate

POLICIES = [None, "moments=int8", "moments=int8g,stats=bf16",
            "moments=bf16,wire_err=int8r", "moments=int8r,stats=int8"]


def _specs(policy, wire, merger):
    x = np.zeros((1, 1001), np.float32)
    tree = {"a": x, "b": np.zeros((1, 77), np.float32)}
    rs = ref_panel.with_residency(ref_panel.with_merger(ref_panel.with_wire(
        ref_panel.make_spec(jax.tree.map(jnp.asarray, tree)), wire),
        merger), policy)
    ps = panel.with_residency(panel.with_merger(panel.with_wire(
        panel.make_spec(jax.tree.map(_t, tree)), wire), merger), policy)
    return rs, ps


@pytest.mark.parametrize("wire,merger", [("f32", "uniform"),
                                         ("int8_ef", "var")])
@pytest.mark.parametrize("policy", POLICIES)
def test_byte_models_match_reference(policy, wire, merger):
    rs, ps = _specs(policy, wire, merger)
    assert ps.residency == rs.residency
    for kind in residency.KINDS:
        assert ps.residency_of(kind) == rs.residency_of(kind)
        for dt in (None, "float32"):
            assert ps.storage_bytes(kind, dt) == rs.storage_bytes(kind, dt)
    for opt_name in ("adamw", "sgd"):
        ro, po = (f(opt_name, 1e-2) for f in (ref_make_optimizer,
                                              make_optimizer))
        assert metrics.fused_moments_auto(ps, po) == \
            ref_metrics.fused_moments_auto(rs, ro)
        for fused in (None, True, False):
            assert metrics.resident_bytes_model(ps, po, fused=fused) == \
                ref_metrics.resident_bytes_model(rs, ro, fused=fused)
            assert metrics.moment_traffic_model(ps, po, 2, fused) == \
                ref_metrics.moment_traffic_model(rs, ro, 2, fused)


def test_fused_predicate_and_refusal():
    init_params, loss_fn = _toy()
    opt = make_optimizer("adamw", 1e-2)
    spec = panel.make_spec(init_params(torch.Generator(), "cpu"), rows=2)
    for name in GROUPED:
        assert metrics.fused_moments_auto(
            panel.with_residency(spec, name), opt)
    for bad in ("int8r", "bf16", None):
        assert not metrics.fused_moments_auto(
            panel.with_residency(spec, bad), opt)
    assert not metrics.fused_moments_auto(
        panel.with_residency(spec, "int8"), make_optimizer("sgd", 1e-2))
    with pytest.raises(ValueError, match="fused"):
        dsgd.make_panel_segment(loss_fn, opt, 2, spec, fused=True)
    with pytest.raises(ValueError, match="fused"):
        dsgd.make_panel_segment(loss_fn, make_optimizer("sgd", 1e-2), 2,
                                panel.with_residency(spec, "int8"),
                                fused=True)


# ------------------------------------------------------------ the segment

DIM, CLASSES, M, H, S = 48, 5, 4, 2, 3


def _toy():
    def init_params(gen, device):
        return {"w": 0.1 * torch.randn((DIM, CLASSES), generator=gen,
                                       device=device),
                "b": torch.zeros((CLASSES,), device=device)}

    def loss_fn(p, batch, rng=None):
        lg = batch["x"] @ p["w"] + p["b"]
        return torch.nn.functional.cross_entropy(lg, batch["y"]), {}

    return init_params, loss_fn


def _batches(seed=0, rounds=S):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((rounds, H, M, 8, DIM))
            .astype(np.float32),
            "y": rng.integers(0, CLASSES, (rounds, H, M, 8))}


def _Ws(rounds=S):
    W = np.eye(M, dtype=np.float32)
    W[:2, :2] = 0.5  # agents 2 and 3 idle
    Ws = [W, np.eye(M, dtype=np.float32)] + [
        np.full((M, M), 1 / M, np.float32)] * (rounds - 2)
    return np.stack(Ws[:rounds])


def _run(policy, fused=None, wire=None, merger=None, rng=1, state=None,
         Ws=None, rounds=S):
    init_params, loss_fn = _toy()
    opt = make_optimizer("adamw", 1e-2)
    if state is None:
        state, spec = dsgd.init_panel_state(init_params, opt, M, 0,
                                            device="cpu", wire=wire,
                                            merger=merger, residency=policy)
    else:
        state, spec = state
    seg = dsgd.make_panel_segment(loss_fn, opt, H, spec, fused=fused)
    out, mets = seg(state, _batches(rounds=rounds),
                    _Ws(rounds) if Ws is None else Ws, rng)
    return spec, out, {k: v.numpy() for k, v in mets.items()}


def _state_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _state_equal(a[k], b[k])
    elif torch.is_tensor(a) or isinstance(a, np.ndarray):
        _same(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", GROUPED)
def test_fused_segment_bit_identical_to_unfused(name):
    pol = {"moments": name, "stats": "int8r"}
    _, a, ma = _run(pol, fused=True, merger="var")
    _, b, mb = _run(pol, fused=False, merger="var")
    _state_equal(a, b)
    _state_equal(ma, mb)
    assert a["opt"]["m"]["float32"]["q"].dtype == torch.int8


def test_f32_policy_is_byte_identical_to_no_policy():
    pol = {"moments": "f32", "stats": "f32", "wire_err": "f32"}
    sa, a, ma = _run(None, wire="int8_ef", merger="fisher")
    sb, b, mb = _run(pol, wire="int8_ef", merger="fisher")
    assert sb.residency == () and sa.residency == ()
    _state_equal(a, b)
    _state_equal(ma, mb)


@pytest.mark.parametrize("name", [n for n in NAMES if n != "f32"])
def test_quantized_moments_track_f32_run(name):
    _, _, base = _run(None)
    _, out, mets = _run({"moments": name})
    assert np.all(np.isfinite(mets["loss"]))
    assert float(np.max(np.abs(mets["loss"] - base["loss"]))) <= 0.05
    mom = out["opt"]["m"]["float32"]
    if name == "bf16":
        assert mom.dtype == torch.bfloat16
    else:
        assert mom["q"].dtype == torch.int8 and mom["scale"].dtype == \
            torch.float32
    assert mets["consensus"][-1] == 0.0


def test_stochastic_policy_needs_rng_and_stored_init():
    init_params, loss_fn = _toy()
    opt = make_optimizer("adamw", 1e-2)
    state, spec = dsgd.init_panel_state(init_params, opt, M, 0,
                                        device="cpu",
                                        residency="moments=int8")
    st = residency.get_storage("int8")
    for k in ("m", "v"):  # built as the canonical stored zero
        _same(state["opt"][k]["float32"], st.init(torch.zeros((M, 245))))
    seg = dsgd.make_panel_segment(loss_fn, opt, H, spec)
    with pytest.raises(ValueError, match="rng"):
        seg(state, _batches(), _Ws())


def test_residency_streams():
    """Fresh generators at every tick, entry and group; none where no
    group rounds stochastically; none without a seed."""
    sts = {"float32": residency.get_storage("int8"),
           "bfloat16": residency.get_storage("int8")}
    draws = set()
    for tick in range(3):
        for entry in range(2):
            gens = residency.storage_generators(sts, 5, tick, "moments",
                                                entry, "cpu")
            for g in gens.values():
                draws.add(float(torch.rand((), generator=g)))
    assert len(draws) == 12
    assert residency.storage_generators(
        {"float32": residency.get_storage("bf16")}, None, 0, "stats", 0,
        "cpu") == {"float32": None}
    with pytest.raises(ValueError, match="seed"):
        residency.storage_generators(sts, None, 0, "wire_err", 0, "cpu")


def test_residency_draws_leave_the_wire_generator_alone():
    """Under int8_ef the wire codec draws the same uniforms with and
    without stochastic moments (its generator ends in the same state), and
    a bf16 policy draws nothing."""
    ends = []
    for pol in (None, "moments=int8", "moments=bf16"):
        gen = torch.Generator().manual_seed(11)
        _run(pol, wire="int8_ef", rng=gen)
        ends.append(gen.get_state())
    assert torch.equal(ends[0], ends[1]) and torch.equal(ends[0], ends[2])
    gen = torch.Generator().manual_seed(11)
    before = gen.get_state()
    _run("moments=bf16,stats=bf16", merger="var", rng=gen)
    assert torch.equal(gen.get_state(), before)


def test_stored_residual_idle_rows_and_idle_rounds_keep_their_bits():
    init_params, loss_fn = _toy()
    opt = make_optimizer("adamw", 1e-2)
    state, spec = dsgd.init_panel_state(
        init_params, opt, M, 0, device="cpu", wire="int8_ef",
        residency="wire_err=int8")
    e0 = {k: v.clone() for k, v in state["wire_err"]["float32"].items()}
    seg = dsgd.make_panel_segment(loss_fn, opt, H, spec)
    W = _Ws()[:1]
    state, _ = seg(state, _batches(rounds=1), W, 1)
    e1 = state["wire_err"]["float32"]
    for part in ("q", "scale"):  # rows 2, 3 sent nothing
        _same(e1[part][2:], e0[part][2:])
        assert not torch.equal(e1[part][:2], e0[part][:2])
    before = {k: v.clone() for k, v in e1.items()}
    state, _ = seg(state, _batches(rounds=1),
                   np.eye(M, dtype=np.float32)[None], 1)
    _same(state["wire_err"]["float32"], before)


def test_decode_stats_on_stored_and_decoded_stats():
    spec, out, _ = _run({"moments": "int8", "stats": "int8r"}, merger="var")
    stored = out["merge_stat"]
    assert stored["traj_mu"]["float32"]["q"].dtype == torch.int8
    dec = merging.decode_stats(stored, spec)
    st = residency.get_storage("int8r")
    for n, grp in stored.items():
        _same(dec[n]["float32"], st.read(grp["float32"]))
    again = merging.decode_stats(dec, spec)
    assert again["traj_mu"]["float32"] is dec["traj_mu"]["float32"]
    assert merging.decode_stats(dec, panel.with_residency(spec, None)) \
        is dec
    # the merged eval reads the stored statistics through decode_stats
    from repro_torch.core import merge as merge_mod
    a = merge_mod.merged_panel_tree(out["panel"], spec, stats=stored)
    b = merge_mod.merged_panel_tree(out["panel"], spec, stats=dec)
    for k in a:
        _same(a[k], b[k])


def test_launcher_residency_int8_on_cpu(tmp_path, capsys):
    args = ["--rounds", "10", "--agents", "4", "--local-steps", "2",
            "--batch", "4", "--seq", "32", "--device", "cpu",
            "--residency", "moments=int8", "--out", str(tmp_path)]
    hist = train.main(args)
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("residency "))
    cfg = train.build_cpu_preset(train.get_config("olmo-1b"), 4)
    model = train.build_model(cfg)
    spec = panel.with_residency(panel.make_spec(
        model.init_params(None, "meta"), rows=4), "moments=int8")
    rb = metrics.resident_bytes_model(spec, make_optimizer("adamw", 3e-3))
    assert line == (
        f"residency moments=int8: {rb['total']} B/agent resident (params "
        f"{rb['params']}, moments {rb['moments']}, wire_err 0, merge_stat "
        f"0); peak {rb['peak']} B/agent (+0 transient); fused moments on")
    assert (tmp_path / "olmo-1b_final_merge_a0.1_rmomentsint8.json").exists()
    last = hist[-1]
    assert last["consensus"] == 0.0
    assert abs(last["local_eval"] - last["merged_eval"]) <= \
        1e-6 * abs(last["merged_eval"])
    assert all(np.isfinite(h["train_loss"]) for h in hist)
