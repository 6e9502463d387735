"""The port's elastic runs (liveness) against the JAX package's.

Mirrors ``tests/test_liveness.py`` (degraded topologies, fault plans, the
(S, m) live mask through the segment, masked merge operators, masked
merged model and consensus) with every ported part held against the
reference on the same inputs: the init handed over from JAX, the same
batches (numpy, from a seed), the same W stack and the same mask. The
reference's segment is jitted, as it runs.

Tolerances: the two packages' float32 runs agree to about 1e-6 at this
size (other summation orders in the gradients and the optimizer), so
panels are held at atol 1e-5 and metrics at rtol 1e-4 (as
``tests/test_torch_segment.py``); rules the port states about its own bits
(dead rows unchanged, an all-live mask equal to no mask, fused equal to
unfused) are held bit for bit. The reference's tree oracle
(``gossip.global_merge_tree(live=)``) has no counterpart in the port yet
(it comes with the tree-state driver); its place is taken by
``merge_panel(live=)`` against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.core import dsgd as ref_dsgd
from repro.core import faults as ref_faults
from repro.core import merge as ref_merge
from repro.core import panel as ref_panel
from repro.core import schedule as ref_schedule
from repro.core import topology as ref_topology
from repro.merging import get_merger as ref_get_merger
from repro.merging import merge_panel as ref_merge_panel
from repro.optim import make_optimizer as ref_make_optimizer
from repro.wire import codec as ref_codec
from repro_torch import merging, residency, wire
from repro_torch.core import dsgd, faults, panel, topology
from repro_torch.core import merge as merge_mod
from repro_torch.core.schedule import make_schedule
from repro_torch.optim import make_optimizer
from repro_torch.weights import from_reference_params

M, H, DIM, CLASSES = 4, 2, 8, 3
ATOL = 1e-5
RTOL = 1e-4
INT8_RTN = wire.Int8Codec("int8_ef", stochastic=False, error_feedback=True)
REF_INT8_RTN = ref_codec.Int8Codec("int8_ef", stochastic=False,
                                   error_feedback=True)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(a, b):
    """Two trees (dicts of tensors, arrays, ints) bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
        return
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.clone()
    return tree.copy() if isinstance(tree, np.ndarray) else tree


def _rows(tree, rows):
    """Rows of every per-agent leaf of a port state part."""
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    return tree[rows].clone() if torch.is_tensor(tree) else tree


# ------------------------------------------------------ the toy problem


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


def _batches(S, seed, m=M):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((S, H, m, 8, DIM)).astype(np.float32),
            "y": rng.integers(0, CLASSES, (S, H, m, 8)).astype(np.int32)}


def _ref_wire(wire_):
    """A registry name as it is; "rtn" the round-to-nearest int8_ef."""
    return {"float32": REF_INT8_RTN} if wire_ == "rtn" else wire_


def _port_wire(wire_):
    """A registry name as it is; "rtn" the round-to-nearest int8_ef."""
    return {"float32": INT8_RTN} if wire_ == "rtn" else wire_


def _states(opt_name="adamw", wire_=None, merger=None, res=None, m=M):
    """(reference state, spec), (port state, spec) from one init (the
    reference's, handed over)."""
    ref_opt = ref_make_optimizer(opt_name, 1e-2)
    opt = make_optimizer(opt_name, 1e-2)
    rs, rspec = ref_dsgd.init_panel_state(
        _ref_init, ref_opt, m, jax.random.PRNGKey(0), wire=_ref_wire(wire_),
        merger=merger, residency=res)
    stacked = jax.tree.map(np.asarray, ref_panel.from_panel(rs["panel"],
                                                            rspec))
    params, _, _ = from_reference_params(stacked, device="cpu")
    ps, pspec = dsgd.panel_state_from_params(
        params, opt, wire=_port_wire(wire_), merger=merger, residency=res)
    return (rs, rspec, ref_opt), (ps, pspec, opt)


def _ref_run(ref, batches, Ws, glob=None, live=None, key=1):
    rs, rspec, ref_opt = ref
    seg = ref_dsgd.make_panel_segment(_ref_loss, ref_opt, H, rspec,
                                      donate=False)
    out, mets = seg(rs, jax.tree.map(jnp.asarray, batches),
                    jnp.asarray(Ws, jnp.float32), jax.random.PRNGKey(key),
                    None, None if glob is None else jnp.asarray(glob),
                    None if live is None else jnp.asarray(live, jnp.int32))
    return (jax.tree.map(np.asarray, out),
            {k: np.asarray(v) for k, v in mets.items()})


def _port_run(port, batches, Ws, glob=None, live=None, rng=1, fused=None):
    ps, pspec, opt = port
    seg = dsgd.make_panel_segment(_loss, opt, H, pspec, fused=fused)
    out, mets = seg(_clone(ps), batches, np.asarray(Ws, np.float32), rng,
                    global_rounds=glob, live=live)
    return out, {k: v.numpy() for k, v in mets.items()}


def _close(port_tree, ref_tree, rows=None, atol=ATOL):
    for k in ref_tree:
        a = _np(port_tree[k])
        b = np.asarray(ref_tree[k])
        if rows is not None:
            a, b = a[rows], b[rows]
        np.testing.assert_allclose(a, b, atol=atol, rtol=ATOL, err_msg=k)


# ------------------------------------------------- degraded topologies


def test_degrade_to_live_matches_reference():
    rng = np.random.default_rng(0)
    W = topology.random_matching(8, 0.7, rng)
    live = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    Wd = topology.degrade_to_live(W, live)
    assert Wd.tobytes() == ref_topology.degrade_to_live(W, live).tobytes()
    np.testing.assert_allclose(Wd.sum(0), 1.0, atol=1e-12)
    np.testing.assert_allclose(Wd.sum(1), 1.0, atol=1e-12)
    for k in np.flatnonzero(~live):
        np.testing.assert_array_equal(Wd[k], np.eye(8)[k])
        np.testing.assert_array_equal(Wd[:, k], np.eye(8)[k])
    np.testing.assert_array_equal(
        topology.degrade_to_live(W, np.ones(8, bool)), W)


def test_fully_connected_live_matches_reference():
    live = np.array([0, 1, 1, 0, 1], bool)
    W = topology.fully_connected_live(live)
    assert W.tobytes() == ref_topology.fully_connected_live(live).tobytes()
    np.testing.assert_allclose(W[np.ix_(live, live)], np.full((3, 3), 1 / 3))
    np.testing.assert_array_equal(
        topology.fully_connected_live(np.zeros(4, bool)), np.eye(4))


def test_schedule_degrades_w_and_reports_live():
    m, rounds = 5, 8
    plan = faults.FaultPlan.parse(m, "2@1-4;4@6")
    ref_plan = ref_faults.FaultPlan.parse(m, "2@1-4;4@6")
    sf = make_schedule("final_merge", m, rounds, seed=3, faults=plan)
    rf = ref_schedule.make_schedule("final_merge", m, rounds, seed=3,
                                    faults=ref_plan)
    s0 = make_schedule("final_merge", m, rounds, seed=3)
    for t in range(rounds):
        Wf, W = sf.mixing_matrix(t), s0.mixing_matrix(t)
        assert Wf.tobytes() == rf.mixing_matrix(t).tobytes()
        assert sf.last_live.tobytes() == rf.last_live.tobytes()
        assert sf.last_kind == rf.last_kind
        np.testing.assert_array_equal(sf.last_live, plan.mask(t))
        assert s0.last_live is None
        alive = sf.last_live == faults.LIVE
        want = (topology.fully_connected_live(alive)
                if sf.last_kind == "global"
                else topology.degrade_to_live(W, alive))
        np.testing.assert_allclose(Wf, want, atol=1e-12)


def test_fault_plan_mask_and_parse_roundtrip():
    plan = faults.FaultPlan.parse(6, "2@5-9; 0@3")
    assert str(plan) == "0@3;2@5-9" == str(ref_faults.FaultPlan.parse(
        6, "2@5-9; 0@3"))
    assert faults.FaultPlan.parse(6, str(plan)).events == plan.events
    np.testing.assert_array_equal(plan.mask(4), [0, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(plan.mask(5), [0, 1, 0, 1, 1, 1])
    np.testing.assert_array_equal(plan.mask(9), [0, 1, 2, 1, 1, 1])
    np.testing.assert_array_equal(plan.mask(10), [0, 1, 1, 1, 1, 1])
    assert not faults.FaultPlan(4)
    assert plan


@pytest.mark.parametrize("spec", ["9@1", "1@5-5", "1@2;1@4", "1@2-6;1@4",
                                  "1@x", "oops"])
def test_fault_plan_rejects(spec):
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError):
            mod.FaultPlan.parse(4, spec)


# --------------------------------------------- segment liveness parity


@pytest.mark.parametrize("wire_,merger,res", [
    ("int8_ef", "fisher", None),
    ("rtn", "var", "moments=int8,stats=int8r,wire_err=int8")])
def test_all_live_mask_is_noop(wire_, merger, res):
    """live == all-ones reproduces live=None bit for bit: the state (panel,
    moments, error-feedback panel, statistics, step) AND the metrics."""
    rng = np.random.default_rng(0)
    Ws = np.stack([topology.random_matching(M, 0.8, rng) for _ in range(2)]
                  + [topology.fully_connected(M)])
    glob = np.array([False, False, True])
    _, port = _states(wire_=wire_, merger=merger, res=res)
    batches = _batches(3, 0)
    a, ma = _port_run(port, batches, Ws, glob)
    b, mb = _port_run(port, batches, Ws, glob, live=np.ones((3, M), int))
    _same(a, b)
    _same(ma, mb)


def test_kill_mid_segment_dead_rows_bit_exact():
    """From its kill round on, every state row of a dead agent (params,
    both moments, error-feedback residual, merge statistics) passes
    through untouched; the survivors match the reference's."""
    ref, port = _states(wire_="rtn", merger="fisher")
    rng = np.random.default_rng(1)
    glob = np.array([False, False, False, True])
    Ws1 = np.stack([topology.random_matching(M, 0.9, rng)
                    for _ in range(2)])
    b1 = _batches(2, 1)
    r_snap, _ = _ref_run(ref, b1, Ws1, glob[:2])
    p_snap, _ = _port_run(port, b1, Ws1, glob[:2])
    live = np.ones(M, bool)
    live[3] = False
    Ws2 = np.stack([topology.degrade_to_live(
        topology.random_matching(M, 0.9, rng), live),
        topology.fully_connected_live(live)])
    b2 = _batches(2, 2)
    lv = np.stack([live, live]).astype(np.int32)
    r_out, r_mets = _ref_run((jax.tree.map(jnp.asarray, r_snap), ref[1],
                              ref[2]), b2, Ws2, glob[2:], lv, key=2)
    p_out, p_mets = _port_run((p_snap, port[1], port[2]), b2, Ws2, glob[2:],
                              lv, rng=2)
    for part in ("panel", "wire_err"):
        _same(_rows(p_out[part], 3), _rows(p_snap[part], 3))
    for mom in ("m", "v"):
        _same(_rows(p_out["opt"][mom], 3), _rows(p_snap["opt"][mom], 3))
    assert p_out["opt"]["step_count"].tolist() == [8, 8, 8, 4]
    _same(_rows(p_out["merge_stat"], 3), _rows(p_snap["merge_stat"], 3))
    assert not torch.equal(p_out["panel"]["float32"][0],
                           p_snap["panel"]["float32"][0])
    surv = [0, 1, 2]
    _close(p_out["panel"], r_out["panel"], surv)
    _close(p_out["merge_stat"]["fisher"], r_out["merge_stat"]["fisher"],
           surv)
    for k in ("loss", "grad_norm", "grad_norm_max", "consensus"):
        np.testing.assert_allclose(p_mets[k], r_mets[k], rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    assert p_mets["consensus"][-1] == 0.0


def test_survivors_match_subgraph_oracle():
    """With agent 3 dead from round 0, the survivors' trajectory equals an
    m' = 3 run on the degraded W's live sub-block, and the reference's."""
    S = 4
    ref, port = _states(opt_name="sgd")
    live = np.array([1, 1, 1, 0], bool)
    rng = np.random.default_rng(2)
    Ws = np.stack([topology.degrade_to_live(
        topology.random_matching(M, 0.9, rng), live) for _ in range(S - 1)]
        + [topology.fully_connected_live(live)])
    glob = np.array([False] * (S - 1) + [True])
    batches = _batches(S, 3)
    lv = np.stack([live] * S).astype(np.int32)
    out4, _ = _port_run(port, batches, Ws, glob, lv)
    r_out, _ = _ref_run(ref, batches, Ws, glob, lv)
    st3 = {"panel": _rows(port[0]["panel"], [0, 1, 2]),
           "opt": _rows(port[0]["opt"], [0, 1, 2]), "step": 0}
    spec3 = panel.make_spec(panel.from_panel(st3["panel"], port[1]))
    out3, _ = _port_run((st3, spec3, port[2]),
                        {k: v[:, :, :3] for k, v in batches.items()},
                        Ws[:, :3, :3], glob)
    np.testing.assert_allclose(out4["panel"]["float32"][:3].numpy(),
                               out3["panel"]["float32"].numpy(), atol=1e-6,
                               rtol=1e-6)
    _close(out4["panel"], r_out["panel"])
    _same(out4["panel"]["float32"][3], port[0]["panel"]["float32"][3])


def test_rejoin_resyncs_without_perturbing_survivors():
    """Plan A (agent 1 rejoins at round 3) and plan B (agent 1 dead for
    good) give bit-identical survivor rows; the rejoiner comes back with the
    live agents' post-mix mean, zero moments and a step count of 0, as the
    reference's."""
    S = 4
    rng = np.random.default_rng(3)
    raw = [topology.random_matching(M, 0.9, rng) for _ in range(S)]
    batches = _batches(S, 4)
    outs = []
    for spec_str in ("1@1-3", "1@1"):
        plan = faults.FaultPlan.parse(M, spec_str)
        lv = np.stack([plan.mask(t) for t in range(S)]).astype(np.int32)
        Ws = np.stack([topology.degrade_to_live(raw[t], lv[t] == faults.LIVE)
                       for t in range(S)])
        ref, port = _states()
        p_out, _ = _port_run(port, batches, Ws, None, lv)
        r_out, _ = _ref_run(ref, batches, Ws, None, lv)
        outs.append((p_out, r_out))
    (rejoin, r_rejoin), (gone, _) = outs
    surv = [0, 2, 3]
    _same(_rows(rejoin["panel"], surv), _rows(gone["panel"], surv))
    x = rejoin["panel"]["float32"]
    np.testing.assert_allclose(x[1].numpy(), x[surv].mean(0).numpy(),
                               atol=1e-6)
    for mom in ("m", "v"):
        assert not torch.any(rejoin["opt"][mom]["float32"][1])
        assert torch.any(gone["opt"][mom]["float32"][1])
    assert rejoin["opt"]["step_count"].tolist() == [8, 0, 8, 8]
    assert gone["opt"]["step_count"].tolist() == [8, 2, 8, 8]
    np.testing.assert_array_equal(rejoin["opt"]["step_count"],
                                  r_rejoin["opt"]["step_count"])
    _close(rejoin["panel"], r_rejoin["panel"])
    _close(rejoin["opt"]["m"], r_rejoin["opt"]["m"], atol=1e-6)


def test_rejoined_agent_trains_on_its_own_step_count():
    """After a RESYNC the rejoined agent's AdamW bias corrections restart
    from its own count (the reference keeps a count per agent): three
    rounds after the rejoin every row matches the reference's."""
    S = 5
    plan = faults.FaultPlan.parse(M, "2@1-2")
    lv = np.stack([plan.mask(t) for t in range(S)]).astype(np.int32)
    rng = np.random.default_rng(5)
    Ws = np.stack([topology.degrade_to_live(
        topology.random_matching(M, 0.9, rng), lv[t] == faults.LIVE)
        for t in range(S)])
    ref, port = _states()
    batches = _batches(S, 6)
    p_out, p_mets = _port_run(port, batches, Ws, None, lv)
    r_out, r_mets = _ref_run(ref, batches, Ws, None, lv)
    assert p_out["opt"]["step_count"].tolist() == [10, 10, 4, 10]
    _close(p_out["panel"], r_out["panel"])
    _close(p_out["opt"]["v"], r_out["opt"]["v"], atol=1e-6)
    for k in ("loss", "grad_norm", "grad_norm_max", "consensus"):
        np.testing.assert_allclose(p_mets[k], r_mets[k], rtol=RTOL,
                                   atol=1e-6, err_msg=k)


def test_int8_ef_rtn_resync_reinits_the_residual():
    """Round-to-nearest int8_ef (deterministic, so the reference's run is
    the same function): a DEAD round, then a RESYNC round whose residual
    row restarts at 0, then a live round; every state part against the
    reference's, and the dead round's residual row bit for bit."""
    S = 3
    plan = faults.FaultPlan.parse(M, "0@0-1")
    lv = np.stack([plan.mask(t) for t in range(S)]).astype(np.int32)
    rng = np.random.default_rng(7)
    Ws = np.stack([topology.degrade_to_live(
        topology.random_matching(M, 1.0, rng), lv[t] == faults.LIVE)
        for t in range(S)])
    ref, port = _states(wire_="rtn")
    batches = _batches(S, 8)
    p_mid, _ = _port_run(port, {k: v[:2] for k, v in batches.items()},
                         Ws[:2], None, lv[:2])
    assert not torch.any(p_mid["wire_err"]["float32"][0])
    assert not torch.any(p_mid["opt"]["m"]["float32"][0])
    p_one, _ = _port_run(port, {k: v[:1] for k, v in batches.items()},
                         Ws[:1], None, lv[:1])
    _same(p_one["wire_err"]["float32"][0], port[0]["wire_err"]["float32"][0])
    _same(p_one["panel"]["float32"][0], port[0]["panel"]["float32"][0])
    p_out, p_mets = _port_run(port, batches, Ws, None, lv)
    r_out, r_mets = _ref_run(ref, batches, Ws, None, lv)
    _close(p_out["panel"], r_out["panel"])
    _close(p_out["wire_err"], r_out["wire_err"], atol=1e-6)
    for k in ("loss", "consensus"):
        np.testing.assert_allclose(p_mets[k], r_mets[k], rtol=RTOL,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------ residency under faults

RES_POLICY = "moments=int8,stats=int8r,wire_err=int8"


def _res_runs(fused):
    """Two all-live rounds, then one elastic round with agent 1 DEAD and
    agent 2 RESYNC (a gossip round), under stochastic stored moments, int8r
    statistics and a stored int8 residual of a round-to-nearest int8_ef."""
    _, port = _states(wire_="rtn", merger="var", res=RES_POLICY)
    rng = np.random.default_rng(9)
    Ws1 = np.stack([topology.random_matching(M, 1.0, rng)
                    for _ in range(2)])
    snap, _ = _port_run(port, _batches(2, 10), Ws1, rng=3, fused=fused)
    lv = np.array([[1, 0, 2, 1]], np.int32)
    W = topology.degrade_to_live(topology.random_matching(M, 1.0, rng),
                                 lv[0] == faults.LIVE)
    out, mets = _port_run((snap, port[1], port[2]), _batches(1, 11),
                          W[None], None, lv, rng=4, fused=fused)
    return port[1], snap, out, mets


@pytest.mark.parametrize("fused", [True, False])
def test_residency_dead_and_resync_rows(fused):
    """DEAD row: every stored bit (moments q and scale, residual q and
    scale, statistics q and scale) as before the round. RESYNC row: the
    live mean, moments the canonical stored zero, count 0, the residual
    the deterministic encode of the codec's fresh residual, the statistics
    the deterministic encode of init_stats of the synced row."""
    spec, snap, out, mets = _res_runs(fused)
    plan = dsgd._res_plan(spec)
    for mom in ("m", "v"):
        _same(_rows(out["opt"][mom], 1), _rows(snap["opt"][mom], 1))
    _same(_rows(out["wire_err"], 1), _rows(snap["wire_err"], 1))
    _same(_rows(out["merge_stat"], 1), _rows(snap["merge_stat"], 1))
    _same(out["panel"]["float32"][1], snap["panel"]["float32"][1])
    x = out["panel"]["float32"]
    mean = torch.matmul(torch.tensor([0.5, 0.0, 0.0, 0.5]), x)
    _same(x[2], mean)
    st = plan["moments"]["float32"]
    zero = st.zeros(1, x.shape[1], "cpu")
    for mom in ("m", "v"):
        _same(_rows(out["opt"][mom]["float32"], [2]), zero)
    assert out["opt"]["step_count"].tolist() == [6, 4, 0, 6]
    fresh = plan["wire_err"]["float32"].init(torch.zeros((1, x.shape[1])))
    _same(_rows(out["wire_err"]["float32"], [2]), fresh)
    stats = merging.get_merger("var").init_stats({"float32": x[2:3]})
    sst = plan["stats"]["float32"]
    for name in ("traj_mu", "traj_m2"):
        _same(_rows(out["merge_stat"][name]["float32"], [2]),
              sst.init(stats[name]["float32"]))
    assert np.isfinite(mets["loss"]).all()


def test_residency_fused_equals_unfused_under_faults():
    a = _res_runs(True)
    b = _res_runs(False)
    _same(a[2], b[2])
    _same(a[3], b[3])
    assert a[2]["opt"]["m"]["float32"]["q"].dtype == torch.int8


def test_residency_bf16_moments_under_faults_match_reference():
    """bf16 moments round deterministically, so the elastic run with a
    DEAD and a RESYNC agent is the reference's to float32 tolerance; the
    rejoined row's moments are the bf16 zero."""
    S = 4
    plan = faults.FaultPlan.parse(M, "1@1-2;3@2")
    lv = np.stack([plan.mask(t) for t in range(S)]).astype(np.int32)
    rng = np.random.default_rng(12)
    Ws = np.stack([topology.degrade_to_live(
        topology.random_matching(M, 1.0, rng), lv[t] == faults.LIVE)
        for t in range(S)])
    ref, port = _states(res="moments=bf16")
    batches = _batches(S, 13)
    p_out, p_mets = _port_run(port, batches, Ws, None, lv)
    r_out, r_mets = _ref_run(ref, batches, Ws, None, lv)
    _close(p_out["panel"], r_out["panel"])
    assert p_out["opt"]["m"]["float32"].dtype == torch.bfloat16
    for mom in ("m", "v"):
        np.testing.assert_allclose(
            p_out["opt"][mom]["float32"].float().numpy(),
            np.asarray(r_out["opt"][mom]["float32"], np.float32), atol=1e-5,
            rtol=1e-2)
    for k in ("loss", "consensus"):
        np.testing.assert_allclose(p_mets[k], r_mets[k], rtol=RTOL,
                                   atol=1e-6, err_msg=k)


# --------------------------------------------- masked merge operators


def _merge_inputs(name, m=6):
    rng = np.random.default_rng(7)
    pan = {"float32": rng.standard_normal((m, 24)).astype(np.float32)}
    gpan = {"float32": rng.standard_normal((m, 24)).astype(np.float32)}
    ref_mg = ref_get_merger(name)
    stats = ref_mg.init_stats({k: jnp.asarray(v) for k, v in pan.items()})
    if stats:
        stats = ref_mg.update_local(stats, {k: jnp.asarray(v)
                                            for k, v in gpan.items()})
        stats = ref_mg.update_round(stats, {k: jnp.asarray(v)
                                            for k, v in pan.items()})
        stats = jax.tree.map(np.asarray, stats)
    return pan, (stats or None)


@pytest.mark.parametrize("name", sorted(merging.MERGERS))
def test_masked_merge_row_matches_subpanel(name):
    """merge_row(live=) equals the operator on the live agents' sub-panel
    and the reference's merge_row(live=) for every operator: dead rows
    contribute nothing, not even through normalisation terms."""
    live = np.array([1, 0, 1, 1, 0, 1], bool)
    pan, stats = _merge_inputs(name)
    sub = np.flatnonzero(live)
    mg = merging.get_merger(name)
    tpan = {k: _t(v) for k, v in pan.items()}
    tstats = (None if stats is None else
              {n: {k: _t(v) for k, v in s.items()} for n, s in stats.items()})
    full = mg.merge_row(tpan, tstats, live=live)
    alone = mg.merge_row({k: v[sub] for k, v in tpan.items()},
                         None if tstats is None else
                         {n: {k: v[sub] for k, v in s.items()}
                          for n, s in tstats.items()})
    ref = ref_get_merger(name).merge_row(
        {k: jnp.asarray(v) for k, v in pan.items()},
        None if stats is None else jax.tree.map(jnp.asarray, stats),
        live=jnp.asarray(live))
    for k in full:
        np.testing.assert_allclose(full[k].numpy(), alone[k].numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(full[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("wire_", ["f32", "rtn", "topk"])
def test_merge_panel_live_rows_and_dead_rows(wire_):
    """merge_panel(live=): live rows take the live sub-panel's merge (the
    reference's), dead rows and their residual or mirror rows pass through
    bit for bit. The weighted operator: TIES on deviations from a mean is
    ill-conditioned on quantized payloads (an ulp of the mean flips a sign
    election), and is held on its own in the test above."""
    m = 5
    live = np.array([1, 1, 0, 1, 0], bool)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((m, 40)).astype(np.float32)
    e = (0.3 * rng.standard_normal((m, 40))).astype(np.float32)
    if wire_ == "topk":
        e = x + e
    spec = panel.with_wire(panel.make_spec({"w": _t(x)}), _port_wire(wire_))
    rspec = ref_panel.with_wire(ref_panel.make_spec({"w": jnp.asarray(x)}),
                                _ref_wire(wire_))
    err = None if wire_ == "f32" else {"float32": _t(e)}
    rerr = None if wire_ == "f32" else {"float32": jnp.asarray(e)}
    mixed, row, ne = merging.merge_panel({"float32": _t(x)}, "weighted",
                                         spec=spec, err=err, live=live)
    rmixed, rrow, rne = ref_merge_panel({"float32": jnp.asarray(x)},
                                        "weighted",
                                        spec=rspec, err=rerr,
                                        live=jnp.asarray(live))
    y = mixed["float32"].numpy()
    np.testing.assert_allclose(row["float32"].numpy(),
                               np.asarray(rrow["float32"]), atol=1e-6)
    np.testing.assert_allclose(y, np.asarray(rmixed["float32"]), atol=1e-6)
    for r in range(m):
        if live[r]:
            _same(y[r], row["float32"].numpy())
        else:
            _same(y[r], x[r])
            if ne is not None:
                _same(ne["float32"][r].numpy(), e[r])
    if ne is not None:
        np.testing.assert_allclose(ne["float32"].numpy(),
                                   np.asarray(rne["float32"]), atol=1e-6)


def test_tree_merges_take_live():
    """merge_stacked / counterfactual_eval / merged_panel_tree (live=)
    against the reference's."""
    m = 5
    live = np.array([1, 1, 0, 1, 0], bool)
    rng = np.random.default_rng(9)
    tree = {"w": rng.standard_normal((m, 7, 3)).astype(np.float32),
            "b": rng.standard_normal((m, 4)).astype(np.float32)}
    got = merge_mod.merge_stacked({k: _t(v) for k, v in tree.items()},
                                  "ties", live=live)
    want = ref_merge.merge_stacked({k: jnp.asarray(v)
                                    for k, v in tree.items()}, "ties",
                                   live=jnp.asarray(live))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
    ev = merge_mod.counterfactual_eval(
        lambda p: torch.sum(p["w"]), {k: _t(v) for k, v in tree.items()},
        live=live)
    np.testing.assert_allclose(float(ev), tree["w"][live].mean(0).sum(),
                               rtol=1e-6)


def test_panel_masked_merged_and_consensus():
    m = 6
    live = np.array([1, 0, 1, 1, 0, 1], bool)
    idx = np.flatnonzero(live)
    x = np.random.default_rng(11).standard_normal((m, 20)).astype(np.float32)
    pan = {"float32": _t(x)}
    row = panel.merged(pan, live=live)
    np.testing.assert_allclose(row["float32"].numpy(), x[idx].mean(0),
                               atol=1e-6)
    rrow = ref_panel.merged({"float32": jnp.asarray(x)},
                            live=jnp.asarray(live))
    np.testing.assert_allclose(row["float32"].numpy(),
                               np.asarray(rrow["float32"]), atol=1e-6)
    xi = float(panel.consensus_distance(pan, live=live))
    sub = x[idx]
    assert xi == pytest.approx(
        np.sqrt(((sub - sub.mean(0)) ** 2).sum() / len(idx)), rel=1e-5)
    assert xi == pytest.approx(float(ref_panel.consensus_distance(
        {"float32": jnp.asarray(x)}, live=jnp.asarray(live))), rel=1e-5)
    # identical live rows read exactly 0 at any live count
    same = np.repeat(x[:1], m, 0)
    same[1] = 0.0
    assert float(panel.consensus_distance({"float32": _t(same)},
                                          live=live)) == 0.0
    g = panel.panel_norm(pan, axis_mean=True,
                         rows=panel._live_weights(live, m))
    assert float(g) == pytest.approx(np.linalg.norm(x[idx].mean(0)),
                                     rel=1e-6)


def test_live_mask_shape_and_values_are_checked():
    _, port = _states()
    seg = dsgd.make_panel_segment(_loss, port[2], H, port[1])
    Ws = np.eye(M, dtype=np.float32)[None]
    for bad in (np.ones((1, M + 1), int), np.full((1, M), 3)):
        with pytest.raises(ValueError, match="live"):
            seg(_clone(port[0]), _batches(1, 0), Ws, live=bad)


# ------------------------------------------------------------ launcher


def test_launcher_faults_matches_reference(tmp_path, monkeypatch):
    """``--faults 2@1-2`` at the CPU preset: the port's launcher (the init
    handed over from the reference's seed) against the reference's own
    launcher, per round: loss, Xi, grad norm; merged and local eval over
    the live agents (rtol 1e-4, as tests/test_torch_segment.py)."""
    import json
    import sys

    from repro.configs import get_config as ref_get_config
    from repro.launch import train as ref_train
    from repro.models import build_model as ref_build_model
    from repro_torch.launch import train
    args = ["--rounds", "6", "--agents", "4", "--local-steps", "2",
            "--batch", "4", "--seq", "32", "--faults", "2@1-2"]
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--out", str(tmp_path / "ref")])
    ref_train.main()
    ref_hist = json.loads(next((tmp_path / "ref").glob("*.json"))
                          .read_text())["history"]
    ref_model = ref_build_model(ref_train.build_cpu_preset(
        ref_get_config("olmo-1b"), 4))
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=12)

    def handover(init_params, opt, m, gen, *, device, merger, wire,
                 residency):
        rs, rspec = ref_dsgd.init_panel_state(
            ref_model.init_params, ref_opt, m, jax.random.PRNGKey(0),
            merger=merger, wire=wire, residency=residency)
        params, _, _ = from_reference_params(jax.tree.map(
            np.asarray, ref_panel.from_panel(rs["panel"], rspec)),
            device=device)
        return dsgd.panel_state_from_params(params, opt, wire=wire,
                                            merger=merger,
                                            residency=residency)

    monkeypatch.setattr(train.dsgd, "init_panel_state", handover)
    hist = train.main(args + ["--device", "cpu", "--out",
                              str(tmp_path / "port")])
    assert len(hist) == len(ref_hist) == 6
    for h, r in zip(hist, ref_hist):
        for k in ("train_loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(h[k], r[k], rtol=RTOL, atol=1e-6,
                                       err_msg=f"round {h['round']} {k}")
    for k in ("merged_eval", "local_eval"):
        np.testing.assert_allclose(hist[-1][k], ref_hist[-1][k], rtol=RTOL)
    assert hist[-1]["consensus"] == 0.0
    assert hist[-1]["merged_eval"] == hist[-1]["local_eval"]
