"""The port's per-agent telemetry (``telemetry/metrics.py`` and
``make_panel_segment(telemetry=True)``) against the JAX package's.

* The metric functions against ``repro.telemetry.metrics`` on inputs made
  from a numpy seed: floats at rtol 1e-5, integers exactly.
* The segment's five (S, m) columns against the reference's
  ``make_panel_segment(telemetry=True)``, the init handed over from JAX:
  the float columns at rtol 1e-4 (the launcher's tolerance: the two
  packages' float32 runs differ by other summation orders), ``live`` and
  ``wire_bytes`` exactly; on the f32 wire, a round-to-nearest int8_ef
  (the packages draw other uniforms for stochastic rounding) and topk,
  with ``live=`` trits. Under ``moments=int8`` the moments round
  stochastically, from other uniforms in each package, so that case runs
  one local step: its stochastically rounded moments have not reached the
  parameters when the columns are read.
* Mirrors of ``tests/test_telemetry.py:104-232``: the columns decompose
  the scalar metrics, follow the trits and the codec byte model, and leave
  the trajectory bit for bit as it is with telemetry off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.core import dsgd as ref_dsgd
from repro.core import panel as ref_panel
from repro.core import topology as ref_topology
from repro.optim import make_optimizer as ref_make_optimizer
from repro.telemetry import metrics as ref_metrics
from repro.wire import codec as ref_codec
from repro_torch import wire
from repro_torch.core import dsgd, panel, topology
from repro_torch.optim import make_optimizer
from repro_torch.telemetry import metrics
from repro_torch.weights import from_reference_params

M, H, DIM, CLASSES = 4, 2, 8, 3
RTOL = 1e-4
FLOAT_COLUMNS = metrics.AGENT_COLUMNS[:3]
INT8_RTN = wire.Int8Codec("int8_ef", stochastic=False, error_feedback=True)
REF_INT8_RTN = ref_codec.Int8Codec("int8_ef", stochastic=False,
                                   error_feedback=True)


# ------------------------------------------------------- metric functions


def _panel(seed, m=M, widths=(37, 11)):
    """{float32: (m, w0), bfloat16: (m, w1)} as numpy float32 values (the
    bfloat16 group's values rounded to bfloat16 first)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, widths[0])).astype(np.float32)
    b = np.asarray(jnp.asarray(rng.normal(size=(m, widths[1])),
                               jnp.bfloat16).astype(jnp.float32))
    return {"float32": a, "bfloat16": b}


def _port_panel(p):
    return {"float32": torch.from_numpy(p["float32"].copy()),
            "bfloat16": torch.from_numpy(p["bfloat16"].copy()).to(
                torch.bfloat16)}


def _ref_panel(p):
    return {"float32": jnp.asarray(p["float32"]),
            "bfloat16": jnp.asarray(p["bfloat16"], jnp.bfloat16)}


@pytest.mark.parametrize("alive", [None, [True, False, True, True]])
def test_agent_float_metrics_match_reference(alive):
    p = _panel(0)
    losses = np.random.default_rng(1).random(M).astype(np.float32) * 5
    al = None if alive is None else np.asarray(alive)
    np.testing.assert_allclose(
        metrics.agent_loss(torch.from_numpy(losses), al).numpy(),
        np.asarray(ref_metrics.agent_loss(
            jnp.asarray(losses), None if al is None else jnp.asarray(al))),
        rtol=1e-5)
    np.testing.assert_allclose(
        metrics.agent_grad_norm(_port_panel(p), al).numpy(),
        np.asarray(ref_metrics.agent_grad_norm(
            _ref_panel(p), None if al is None else jnp.asarray(al))),
        rtol=1e-5)
    np.testing.assert_allclose(
        metrics.agent_dist_to_mean(_port_panel(p), live=al).numpy(),
        np.asarray(ref_metrics.agent_dist_to_mean(
            _ref_panel(p), live=None if al is None else jnp.asarray(al))),
        rtol=1e-5)


def test_dist_to_mean_slabs_and_identical_rows(monkeypatch):
    """Column slabs change no number; identical (live) rows read 0 exactly
    at any count; the squares' live mean is the live Xi."""
    p = _port_panel(_panel(2, widths=(1000, 3)))
    whole = metrics.agent_dist_to_mean(p)
    monkeypatch.setattr(metrics, "DIST_SLAB", 7)
    torch.testing.assert_close(metrics.agent_dist_to_mean(p), whole,
                               rtol=1e-6, atol=0.0)
    alive = np.array([True, True, False, True])
    row = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 1000)).astype(np.float32) / 3)
    same = {"float32": row.repeat(M, 1)}
    same["float32"][2] += 1.0
    d = metrics.agent_dist_to_mean(same, live=alive).numpy()
    assert d[[0, 1, 3]].tolist() == [0.0, 0.0, 0.0] and d[2] > 0
    x = _port_panel(_panel(4, widths=(300, 5)))
    d = metrics.agent_dist_to_mean(x, live=alive).numpy()
    np.testing.assert_allclose(
        np.sqrt(np.mean(np.square(d[alive]))),
        float(panel.consensus_distance(x, live=alive)), rtol=1e-6)


def _specs(wire_):
    """The reference's and the port's spec of one stacked tree (f32 and
    bf16 leaves), with the wire policy ``wire_``."""
    rng = np.random.default_rng(0)
    tree = {"b": rng.normal(size=(M, 5)).astype(np.float32),
            "e": rng.normal(size=(M, 3, 4)).astype(np.float32),
            "w": rng.normal(size=(M, 300)).astype(np.float32)}
    rs = ref_panel.with_wire(ref_panel.make_spec(
        {**jax.tree.map(jnp.asarray, tree),
         "e": jnp.asarray(tree["e"], jnp.bfloat16)}), wire_)
    ps = panel.with_wire(panel.make_spec(
        {**{k: torch.from_numpy(v) for k, v in tree.items()},
         "e": torch.from_numpy(tree["e"]).to(torch.bfloat16)}), wire_)
    return rs, ps


@pytest.mark.parametrize("wire_", [None, "f32", "int8_ef", "int4", "topk",
                                   "bf16"])
def test_byte_models_match_reference(wire_):
    rs, ps = _specs(wire_)
    assert metrics.wire_bytes_model(ps) == ref_metrics.wire_bytes_model(rs)
    if wire_ is None:
        assert metrics.wire_bytes_model(ps, wire_dtype=torch.bfloat16) == \
            ref_metrics.wire_bytes_model(rs, wire_dtype=jnp.bfloat16)
        assert metrics.wire_bytes_model(ps, wire_dtype="bfloat16") == \
            ref_metrics.wire_bytes_model(rs, wire_dtype=jnp.bfloat16)
    opt, ref_opt = make_optimizer("adamw", 1e-2), ref_make_optimizer(
        "adamw", 1e-2)
    for wd in ((None, None), ("bfloat16", jnp.bfloat16)):
        if wd[0] is not None and wire_ is not None:
            continue
        assert metrics.resident_bytes_model(ps, opt, wire_dtype=wd[0]) == \
            ref_metrics.resident_bytes_model(rs, ref_opt, wire_dtype=wd[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_wire_bytes_and_live_trits_match_reference(seed):
    rng = np.random.default_rng(seed)
    m = 6
    Ws = [ref_topology.random_matching(m, 0.7, rng), np.eye(m),
          ref_topology.fully_connected(m)]
    lvs = [None, rng.integers(0, 3, m).astype(np.int32)]
    for W in Ws:
        for lv in lvs:
            for fb in (None, False, True):
                kw = dict(bytes_wire=10 + seed, bytes_full=40 + seed)
                got = metrics.round_wire_bytes(W, full_bandwidth=fb, lv=lv,
                                               **kw)
                want = ref_metrics.round_wire_bytes(
                    jnp.asarray(W, jnp.float32),
                    full_bandwidth=None if fb is None else jnp.asarray(fb),
                    lv=None if lv is None else jnp.asarray(lv), **kw)
                assert got.dtype == np.int64
                np.testing.assert_array_equal(got, np.asarray(want))
        for lv in lvs:
            np.testing.assert_array_equal(
                metrics.live_trits(lv, m), np.asarray(ref_metrics.live_trits(
                    None if lv is None else jnp.asarray(lv), m)))
    # exact above 2 GiB an agent-round, where the reference's int32 wraps
    big = metrics.round_wire_bytes(Ws[2], bytes_wire=3 << 31,
                                   bytes_full=5 << 31)
    assert big.tolist() == [3 << 31] * m


# ------------------------------------------------- the segment's columns


def _ref_init(rng):
    k1, _ = jax.random.split(rng)
    return {"w": jax.random.normal(k1, (DIM, CLASSES)) * 0.1,
            "b": jnp.zeros(CLASSES)}


def _ref_loss(p, batch, rng=None):
    lg = batch["x"] @ p["w"] + p["b"]
    nll = jnp.mean(jax.nn.logsumexp(lg, -1)
                   - jnp.take_along_axis(lg, batch["y"][:, None], -1)[:, 0])
    return nll, {}


def _loss(p, batch, rng=None):
    lg = batch["x"] @ p["w"] + p["b"]
    return torch.nn.functional.cross_entropy(lg, batch["y"].long()), {}


def _batches(S, seed, h=H):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((S, h, M, 8, DIM)).astype(np.float32),
            "y": rng.integers(0, CLASSES, (S, h, M, 8)).astype(np.int32)}


def _states(wire_=None, res=None, merger=None):
    ref_opt = ref_make_optimizer("adamw", 1e-2)
    opt = make_optimizer("adamw", 1e-2)
    rw = {"float32": REF_INT8_RTN} if wire_ == "rtn" else wire_
    pw = {"float32": INT8_RTN} if wire_ == "rtn" else wire_
    rs, rspec = ref_dsgd.init_panel_state(
        _ref_init, ref_opt, M, jax.random.PRNGKey(0), wire=rw,
        residency=res, merger=merger)
    stacked = jax.tree.map(np.asarray, ref_panel.from_panel(rs["panel"],
                                                            rspec))
    params, _, _ = from_reference_params(stacked, device="cpu")
    ps, pspec = dsgd.panel_state_from_params(params, opt, wire=pw,
                                             residency=res, merger=merger)
    return (rs, rspec, ref_opt), (ps, pspec, opt)


def _ref_seg(ref, batches, Ws, glob, live, h=H):
    rs, rspec, ref_opt = ref
    seg = ref_dsgd.make_panel_segment(_ref_loss, ref_opt, h, rspec,
                                      telemetry=True, donate=False)
    _, mets = seg(rs, jax.tree.map(jnp.asarray, batches),
                  jnp.asarray(Ws, jnp.float32), jax.random.PRNGKey(1), None,
                  jnp.asarray(glob),
                  None if live is None else jnp.asarray(live, jnp.int32))
    return {k: np.asarray(v) for k, v in mets.items()}


def _port_seg(port, batches, Ws, glob, live, h=H, telemetry=True):
    ps, pspec, opt = port
    seg = dsgd.make_panel_segment(_loss, opt, h, pspec, telemetry=telemetry)
    out, mets = seg(ps, batches, np.asarray(Ws, np.float32), 1,
                    global_rounds=glob, live=live)
    return out, {k: v.numpy() for k, v in mets.items()}


def _plan(S, faults=True):
    """S rounds: gossip matchings degraded to the trits' live agents, the
    last the (live) global merge; with ``faults`` agent 0 dead in round 1
    and rejoining in round 2, agent 3 dead from round 3 (else all live)."""
    rng = np.random.default_rng(5)
    trits = np.ones((S, M), np.int32)
    if faults:
        trits[1, 0], trits[2, 0] = 0, 2
        trits[3:, 3] = 0
    Ws = []
    for s in range(S):
        alive = trits[s] == 1
        if s == S - 1:
            Ws.append(topology.fully_connected_live(alive))
        else:
            Ws.append(topology.degrade_to_live(
                topology.random_matching(M, 0.9, rng), alive))
    glob = np.arange(S) == S - 1
    return np.stack(Ws), glob, trits


@pytest.mark.parametrize("wire_,res,S,h,live", [
    (None, None, 4, H, False), (None, None, 5, H, True),
    ("rtn", None, 5, H, True), ("topk", None, 4, H, False),
    ("topk", None, 5, H, True), (None, "moments=int8", 1, 1, True),
    ("rtn", "moments=int8", 1, 1, False)])
def test_segment_columns_match_reference(wire_, res, S, h, live):
    ref, port = _states(wire_, res)
    if S > 1:
        Ws, glob, trits = _plan(S, live)
    else:  # one gossip round; under live=, agent 2 dead
        Ws = np.stack([topology.random_matching(M, 0.9,
                                                np.random.default_rng(6))])
        glob = np.array([False])
        trits = np.array([[1, 1, 0, 1]], np.int32)
        if live:
            Ws = np.stack([topology.degrade_to_live(Ws[0], trits[0] == 1)])
    batches = _batches(S, 7, h)
    lv = trits if live else None
    want = _ref_seg(ref, batches, Ws, glob, lv, h)
    _, got = _port_seg(port, batches, Ws, glob, lv, h)
    for k in FLOAT_COLUMNS:
        assert got[k].shape == (S, M) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    for k in ("live", "wire_bytes"):
        assert got[k].dtype == np.int64
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("loss", "grad_norm", "grad_norm_max", "consensus"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    if S > 1:
        assert got["dist_to_mean"][-1][trits[-1] == 1].max() == 0.0


# ------------------------------------- mirrors of tests/test_telemetry.py


def _matchings(S, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([topology.random_matching(M, 0.5, rng)
                     for _ in range(S)]).astype(np.float32)


def test_segment_per_agent_metrics_decompose_scalars():
    """The columns decompose the scalar metrics (loss is the mean of
    loss_agent, Xi is sqrt(mean(dist_to_mean^2))) and follow the codec
    byte model: idle rows of W pay 0, the others wire_total_bytes."""
    S = 4
    _, (ps, spec, opt) = _states("int8")
    seg = dsgd.make_panel_segment(_loss, opt, H, spec, telemetry=True)
    Ws = _matchings(S)
    _, mets = seg(ps, _batches(S, 0), Ws, 7)
    mets = {k: v.numpy() for k, v in mets.items()}
    for k in FLOAT_COLUMNS:
        assert mets[k].shape == (S, M), k
    np.testing.assert_allclose(np.mean(mets["loss_agent"], axis=1),
                               mets["loss"], rtol=1e-5)
    np.testing.assert_allclose(
        np.sqrt(np.mean(mets["dist_to_mean"] ** 2, axis=1)),
        mets["consensus"], rtol=1e-4)
    assert np.all(mets["grad_norm_agent"] > 0)
    np.testing.assert_array_equal(mets["live"], np.ones((S, M), np.int64))
    idle = np.all(Ws == np.eye(M, dtype=np.float32), axis=2)
    np.testing.assert_array_equal(
        mets["wire_bytes"], np.where(idle, 0, spec.wire_total_bytes))


def test_segment_liveness_metrics_follow_trits():
    """DEAD rows report 0 loss and 0 wire bytes; RESYNC rows pay the
    full-precision pull; the live column is the trit mask verbatim."""
    S = 3
    _, (ps, spec, opt) = _states("int8")
    seg = dsgd.make_panel_segment(_loss, opt, H, spec, telemetry=True)
    W = np.eye(M, dtype=np.float32)
    W[1, 1] = W[2, 2] = W[1, 2] = W[2, 1] = 0.5
    live = np.array([[1, 1, 1, 1], [0, 1, 1, 1], [2, 1, 1, 1]])
    _, mets = seg(ps, _batches(S, 0), np.stack([W] * S), 7,
                  global_rounds=np.zeros(S, bool), live=live)
    mets = {k: v.numpy() for k, v in mets.items()}
    np.testing.assert_array_equal(mets["live"], live)
    full = metrics.wire_bytes_model(spec)[1]
    wb = mets["wire_bytes"]
    np.testing.assert_array_equal(
        wb[0], [0, spec.wire_total_bytes, spec.wire_total_bytes, 0])
    assert wb[1][0] == 0 and wb[2][0] == full
    assert mets["loss_agent"][1][0] == 0.0
    assert mets["loss_agent"][2][0] == 0.0
    assert mets["grad_norm_agent"][1][0] == 0.0
    assert mets["loss_agent"][1][1] > 0.0


@pytest.mark.parametrize("wire_,res,live", [
    ("int8", None, False), ("topk", "moments=int8", False),
    ("int8_ef", "moments=int8,stats=int8r,wire_err=int8", True)])
def test_telemetry_never_perturbs_trajectory(wire_, res, live):
    """The segment's final state (panels, moments, error-feedback and
    statistics panels, step counts) and its scalar metrics are bit for bit
    the same with telemetry on or off."""
    S = 5
    Ws, glob, trits = _plan(S)
    outs, scalars = [], []
    for tel in (False, True):
        _, port = _states(wire_, res, merger="var")
        out, mets = _port_seg(port, _batches(S, 3), Ws, glob,
                              trits if live else None, telemetry=tel)
        outs.append(out)
        scalars.append({k: mets[k] for k in ("loss", "grad_norm",
                                             "grad_norm_max", "consensus")})

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)

    same(outs[0], outs[1])
    same(scalars[0], scalars[1])


def test_round_wire_bytes_unit():
    W = np.eye(4, dtype=np.float32)
    z = metrics.round_wire_bytes(W, bytes_wire=10, bytes_full=40)
    np.testing.assert_array_equal(z, 0)
    W[0, 0] = W[0, 1] = W[1, 1] = W[1, 0] = 0.5
    b = metrics.round_wire_bytes(W, bytes_wire=10, bytes_full=40)
    np.testing.assert_array_equal(b, [10, 10, 0, 0])
    b = metrics.round_wire_bytes(W, bytes_wire=10, bytes_full=40,
                                 full_bandwidth=True)
    np.testing.assert_array_equal(b, [40, 40, 0, 0])
    lv = np.asarray([0, 1, 2, 1], np.int32)
    b = metrics.round_wire_bytes(W, bytes_wire=10, bytes_full=40, lv=lv)
    np.testing.assert_array_equal(b, [0, 10, 40, 0])
