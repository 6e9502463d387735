"""The port's merge operators against the JAX package's.

Inputs are made with numpy from a seed and go through both packages. The
cases mirror ``tests/test_merge_props.py`` as parametrised cases:

* the plain ``weighted_colmerge`` and ``ties_colmerge`` against the
  reference's oracles (``kernels/ref.py``, eager) BIT FOR BIT, and against
  its Pallas kernels in interpret mode: TIES bit for bit; the weighted
  merge within 1e-6, because the reference's own Pallas kernel sums its
  block in another order than its oracle (1-2 ulp, ROADMAP C). The TIES
  inputs are the reference's deviations and thresholds;
* the TIES thresholds against ``jnp.quantile`` bit for bit, jitted (as
  the reference's segment runs it) and eager for m >= 2 rows: XLA fuses
  the interpolation into one multiply-add, and the port computes that same
  fused form (``ref.ties_thresh_ref``); for a single row, outside an outer
  jit, XLA fuses the other product, within 1 ulp;
* each operator's ``merge_row`` and statistics updates against the
  reference's on the same panel and statistics (handed over through
  ``weights.merge_stat_from_reference``): bit for bit, but the weighted
  operator's agent sum (within 1e-6);
* the operator properties (uniform weights and fresh stats give the mean,
  agent permutation equivariance at 1e-5, idempotence on identical rows at
  1e-6, TIES's sign election and trim, validation) on the port alone;
* the segment end to end (toy problem, port alone): global rounds through
  the operator (Xi exactly 0, rows identical, stats updated) against
  ``merge_stacked`` of the segment's own pre-merge state, 'uniform'
  byte-identical to the merger-less engine, the ``global_rounds`` mask at
  m = 2, swa skipping the wire, a codec composed with a merger;
* the segment at the verify recipe's size (reduced olmo-1b, 4 agents, 10
  rounds, 2 AdamW steps) under every non-uniform operator against the
  jitted reference segment: per-round loss, grad norms and Xi at rtol 1e-4
  (as ``tests/test_torch_segment.py``: 20 AdamW steps amplify float32
  rounding); the global merge itself held by merging the REFERENCE's
  pre-merge state with the port (its panel and statistics handed over)
  against the reference operator's row, bit for bit, and against the
  reference segment's row within 1e-6 (see the test for 'var'); merged and
  local eval
  at rtol 1e-4 — except TIES, whose merge on deviations from the mean is
  ill-conditioned: every deviation column sums to 0 up to rounding, so
  where all agents survive the trim the elected sign is decided by the
  rounding (a 1-ulp change of the port's OWN initial panel moves its TIES
  merged eval by 9.4e-3 relative, measured by
  ``test_ties_merge_is_ill_conditioned_at_the_verify_size``), so its evals
  after the merge are not compared across packages and its merge is held
  by the handover;
* the launcher with ``--merge ties`` on the CPU.

The verify-size cases and the launcher live in
``tests/test_torch_merge_verify.py`` (a file of their own, so that a run
with one worker a file spreads them over another worker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro import merging as ref_merging
from repro.core import merge as ref_merge
from repro.kernels import merge_ops as jmo
from repro.kernels import ref as jref
from repro_torch import merging
from repro_torch.core import dsgd, panel
from repro_torch.core import merge as merge_mod
from repro_torch.core.topology import random_matching
from repro_torch.kernels import merge_ops as pmo
from repro_torch.kernels import ref as pref
from repro_torch.optim import make_optimizer
from repro_torch.weights import merge_stat_from_reference

ALL = tuple(sorted(merging.MERGERS))
NON_UNIFORM = tuple(n for n in ALL if n != "uniform")
KERNEL_SWEEP = [(4, 64, 32), (8, 333, 128), (3, 1000, 512)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return np.asarray(x)


def _panel(m, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)) * scale).astype(np.float32)


def _ref_rich_stats(name, x, seed=0):
    """The reference's statistics for panel x after two updates (fresh
    stats plus fake gradients / parameters), so the weights differ."""
    mg = ref_merging.get_merger(name)
    if not mg.stat_panels:
        return None, None
    pan = {"float32": jnp.asarray(x)}
    stats = mg.init_stats(pan)
    g = _panel(*x.shape, seed + 7) * 0.3
    p = x + _panel(*x.shape, seed + 8) * 0.1
    for _ in range(2):
        if mg.local_stat:
            stats = mg.update_local(stats, {"float32": jnp.asarray(g)})
        if mg.round_stat:
            stats = mg.update_round(stats, {"float32": jnp.asarray(p)})
    return stats, (g, p)


def _handover(stats, x):
    if stats is None:
        return None
    spec = panel.make_spec({"w": _t(x)})
    return merge_stat_from_reference(
        jax.tree.map(np.asarray, stats), spec, device="cpu")


# ------------------------------------------------------- plain versions


@pytest.mark.parametrize("m,D,block_d", KERNEL_SWEEP)
def test_weighted_colmerge_matches_oracle_and_pallas(m, D, block_d):
    x = _panel(m, D, seed=m * 100 + D)
    w = np.random.default_rng(D).uniform(1e-3, 2.0, (m, D)).astype(
        np.float32)
    got = pmo.weighted_colmerge(_t(x), _t(w)).numpy()
    oracle = _np(jref.weighted_colmerge_ref(jnp.asarray(x), jnp.asarray(w)))
    pallas = _np(jmo.weighted_colmerge(jnp.asarray(x), jnp.asarray(w),
                                       block_d=block_d))
    assert got.shape == (D,) and got.dtype == np.float32
    assert got.tobytes() == oracle.tobytes()
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("trim", [0.2, 1.0])
@pytest.mark.parametrize("m,D,block_d", KERNEL_SWEEP)
def test_ties_colmerge_matches_oracle_and_pallas(m, D, block_d, trim):
    x = jnp.asarray(_panel(m, D, seed=m * 10 + D))
    tau = x - jnp.mean(x, axis=0)[None]
    thresh = jref.ties_thresh_ref(tau, trim)
    got = pmo.ties_colmerge(_t(tau), _t(thresh)).numpy()
    oracle = _np(jref.ties_colmerge_ref(tau, thresh))
    pallas = _np(jmo.ties_colmerge(tau, thresh, block_d=block_d))
    assert got.tobytes() == oracle.tobytes() == pallas.tobytes()


@pytest.mark.parametrize("trim", [0.2, 1.0, 0.37, 1e-3])
@pytest.mark.parametrize("m,D", [(4, 64), (8, 333), (3, 1000), (1, 257),
                                 (2, 1)])
def test_ties_thresholds_equal_jnp_quantile(m, D, trim):
    rng = np.random.default_rng(m * D)
    tau = (rng.standard_normal((m, D))
           * np.exp(rng.uniform(-5, 5, (m, 1)))).astype(np.float32)
    got = pref.ties_thresh_ref(_t(tau), trim)
    eager = _np(jref.ties_thresh_ref(jnp.asarray(tau), trim))
    jitted = _np(jax.jit(lambda t: jref.ties_thresh_ref(t, trim))(
        jnp.asarray(tau)))
    assert got.shape == (m, 1) and got.dtype == torch.float32
    assert got.numpy().tobytes() == jitted.tobytes()
    if m > 1:
        assert got.numpy().tobytes() == eager.tobytes()
    else:  # one row: XLA fuses the other product outside an outer jit
        np.testing.assert_array_max_ulp(got.numpy(), eager, maxulp=1)


def test_ties_thresholds_nan_row_and_float32_index():
    tau = _panel(3, 10, 5)
    tau[1, 3] = np.nan
    got = pref.ties_thresh_ref(_t(tau), 0.2).numpy()[:, 0]
    want = _np(jref.ties_thresh_ref(jnp.asarray(tau), 0.2))[:, 0]
    assert np.isnan(got[1]) and np.isnan(want[1])
    np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
    # the float32 index arithmetic at olmo-1b's width (2 layers)
    q, n = np.float32(1.0 - 0.2), np.float32(237502464)
    pos = q * (n - np.float32(1.0))
    assert int(pos) == 190001968 and pos == np.floor(pos)
    with pytest.raises(ValueError, match="trim"):
        pref.ties_thresh_ref(_t(tau), 0.0)


def test_wrappers_reject_other_devices():
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError):
        pmo.weighted_colmerge(x, x.to("meta"))
    with pytest.raises(ValueError):
        pmo.ties_colmerge(x.to("meta"), torch.zeros((2, 1), device="meta"))


# --------------------------------------------------- operators vs JAX


@pytest.mark.parametrize("name", ALL)
def test_merge_row_matches_reference(name):
    x = _panel(8, 700, 31)
    stats, _ = _ref_rich_stats(name, x, seed=31)
    w = np.random.default_rng(5).uniform(0.1, 1.0, 8).astype(np.float32)
    kw = {"weights": w} if name == "weighted" else {}
    want = _np(ref_merging.get_merger(name).merge_row(
        {"float32": jnp.asarray(x)}, stats=stats, **kw)["float32"])
    got = merging.get_merger(name).merge_row(
        {"float32": _t(x)}, stats=_handover(stats, x),
        **kw)["float32"].numpy()
    assert got.shape == (700,) and got.dtype == np.float32
    # weighted: the reference's tensordot sums in XLA's order. The column
    # means agree bit for bit at m = 8 only: jnp.mean multiplies by 1/m,
    # the port divides by m (exact alike for a power of two)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name != "weighted":
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["var", "fisher", "swa"])
def test_stat_updates_match_reference(name):
    """init_stats and the in-place EMA updates give the reference's
    statistics bit for bit (each product rounded on its own, one rounded
    sum, as the reference's eager expression)."""
    x = _panel(4, 300, 41)
    stats, (g, p) = _ref_rich_stats(name, x, seed=41)
    mg = merging.get_merger(name)
    mine = mg.init_stats({"float32": _t(x)})
    for _ in range(2):
        if mg.local_stat:
            mine = mg.update_local(mine, {"float32": _t(g)})
        if mg.round_stat:
            mine = mg.update_round(mine, {"float32": _t(p)})
    assert sorted(mine) == sorted(stats) == sorted(mg.stat_panels)
    for sn in mine:
        assert (mine[sn]["float32"].numpy().tobytes()
                == _np(stats[sn]["float32"]).tobytes())


def test_init_stats_copy_the_panel():
    x = _t(_panel(3, 8, 2))
    for name in ("var", "swa"):
        st = merging.get_merger(name).init_stats({"float32": x})
        for grp in st.values():
            assert grp["float32"].data_ptr() != x.data_ptr()


def test_merge_stat_handover_checks_widths():
    spec = panel.make_spec({"w": torch.zeros((3, 8))})
    good = {"fisher": {"float32": np.ones((3, 8), np.float32)}}
    out = merge_stat_from_reference(good, spec, device="cpu")
    assert out["fisher"]["float32"].dtype == torch.float32
    with pytest.raises(ValueError, match="width"):
        merge_stat_from_reference(
            {"fisher": {"float32": np.ones((3, 9), np.float32)}}, spec,
            device="cpu")
    with pytest.raises(ValueError, match="groups"):
        merge_stat_from_reference(
            {"fisher": {"bfloat16": np.ones((3, 8), np.float32)}}, spec,
            device="cpu")


# ------------------------------------------------ operator properties


@pytest.mark.parametrize("m,d,seed", [(2, 1, 0), (5, 17, 1), (8, 64, 2)])
def test_uniform_weights_weighted_recovers_mean(m, d, seed):
    x = _t(_panel(m, d, seed))
    row = merging.get_merger("weighted").merge_row(
        {"float32": x}, weights=torch.full((m,), 1.0 / m))
    torch.testing.assert_close(row["float32"], torch.mean(x, 0), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("name", ["var", "fisher"])
@pytest.mark.parametrize("m,d,seed", [(2, 1, 3), (5, 17, 4), (8, 64, 5)])
def test_fresh_stats_var_fisher_recover_mean(name, m, d, seed):
    x = _t(_panel(m, d, seed))
    mg = merging.get_merger(name)
    row = mg.merge_row({"float32": x}, stats=mg.init_stats({"float32": x}))
    torch.testing.assert_close(row["float32"], torch.mean(x, 0), atol=1e-5,
                               rtol=1e-5)


def _port_rich_stats(name, x, seed):
    stats, _ = _ref_rich_stats(name, x.numpy(), seed)
    return _handover(stats, x.numpy())


@pytest.mark.parametrize("name", ALL)
def test_permutation_of_agents_equivariance(name):
    m, d = 6, 41
    x = _t(_panel(m, d, 11))
    stats = _port_rich_stats(name, x, 11)
    w = torch.from_numpy(np.random.default_rng(5).uniform(
        0.1, 1.0, m).astype(np.float32))
    perm = torch.tensor([3, 0, 5, 1, 4, 2])
    stats_p = (None if stats is None else
               {n: {k: v[perm] for k, v in s.items()}
                for n, s in stats.items()})
    mg = merging.get_merger(name)
    a = mg.merge_row({"float32": x}, stats=stats,
                     weights=w if name == "weighted" else None)
    b = mg.merge_row({"float32": x[perm]}, stats=stats_p,
                     weights=w[perm] if name == "weighted" else None)
    torch.testing.assert_close(a["float32"], b["float32"], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", ALL)
def test_idempotent_on_identical_rows(name):
    m, d = 5, 37
    row0 = _t(_panel(1, d, 21))[0]
    x = row0[None].expand(m, d).contiguous()
    mg = merging.get_merger(name)
    stats = mg.init_stats({"float32": x}) or None
    out = mg.merge_row({"float32": x}, stats=stats)
    torch.testing.assert_close(out["float32"], row0, atol=1e-6, rtol=0)


@pytest.mark.parametrize("m,d,seed", [(2, 2, 6), (4, 48, 7), (6, 31, 8)])
def test_ties_full_trim_is_sign_elected_mean(m, d, seed):
    """Computed independently from the port's deviations: every deviation
    column sums to 0 up to rounding, so the elected sign depends on the
    float32 deviations themselves and the oracle must start from them."""
    x = _panel(m, d, seed)
    row = merging.TiesMerger(trim=1.0).merge_row({"float32": _t(x)})
    mean = panel.merged({"float32": _t(x)})["float32"].numpy()
    tau = x - mean[None]
    col = tau[0].copy()
    for k in range(1, m):  # the float32 column sum, in row order
        col += tau[k]
    s = np.where(col >= 0.0, 1.0, -1.0)
    tau = tau.astype(np.float64)
    agree = (tau * s[None]) > 0.0
    cnt = agree.sum(0)
    dev = np.where(cnt > 0, (tau * agree).sum(0) / np.maximum(cnt, 1), 0.0)
    np.testing.assert_allclose(row["float32"].numpy(), mean + dev,
                               atol=1e-6, rtol=1e-6)


def test_ties_elects_majority_sign_and_trims():
    x = torch.tensor([[1.0, 0.1], [1.0, 0.1], [1.0, -0.1], [-3.0, -0.1]])
    pan = {"float32": x + 5.0}  # mean 5, deviations x
    row = merging.TiesMerger(trim=1.0).merge_row(pan)["float32"]
    assert abs(float(row[0]) - 6.0) <= 6e-6  # + elected, three +1s
    assert abs(float(row[1]) - 5.1) <= 5e-5  # a sum of 0 elects +
    row = merging.TiesMerger(trim=0.5).merge_row(pan)["float32"]
    assert abs(float(row[1]) - 5.0) <= 1e-6  # nothing survives


@pytest.mark.parametrize("trim", [0.0, 1.5, -0.1])
def test_ties_trim_validation(trim):
    with pytest.raises(ValueError, match="trim"):
        merging.TiesMerger(trim=trim)


def test_with_merger_validation():
    spec = panel.make_spec({"w": torch.zeros((2, 8))})
    assert spec.merger == "uniform"
    assert panel.with_merger(spec, "ties").merger == "ties"
    assert panel.with_merger(spec, None).merger == "uniform"
    with pytest.raises(ValueError, match="unknown merge operator"):
        panel.with_merger(spec, "tias")
    with pytest.raises(ValueError, match="registry NAME"):
        panel.with_merger(spec, merging.TiesMerger(trim=0.5))


def test_get_merger_registry_and_passthrough():
    assert sorted(merging.MERGERS) == sorted(ref_merging.MERGERS)
    mg = merging.TiesMerger(trim=0.7)
    assert merging.get_merger(mg) is mg
    assert merging.get_merger("swa") is merging.MERGERS["swa"]
    with pytest.raises(ValueError) as exc:
        merging.get_merger("nope")
    assert all(n in str(exc.value) for n in ALL)
    for name in ALL:
        mine, ref = merging.MERGERS[name], ref_merging.MERGERS[name]
        for attr in ("stat_panels", "local_stat", "round_stat",
                     "uses_panel"):
            assert getattr(mine, attr) == getattr(ref, attr), (name, attr)


@pytest.mark.parametrize("name", ["var", "fisher", "swa"])
def test_stats_mergers_refuse_missing_stats(name):
    with pytest.raises(ValueError, match="stats"):
        merging.get_merger(name).merge_row({"float32": _t(_panel(3, 8, 2))})


# ----------------------------------------------------- engine, toy size


def _toy(dim=10, classes=3):
    def init_params(gen, device):
        return {"w": 0.1 * torch.randn((dim, classes), generator=gen,
                                       device=device),
                "b": torch.zeros((classes,), device=device)}

    def loss_fn(p, batch, rng=None):
        lg = batch["x"] @ p["w"] + p["b"]
        return torch.nn.functional.cross_entropy(lg, batch["y"]), {}

    return init_params, loss_fn


def _toy_batches(S, H, m, dim=10, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((S, H, m, 8, dim)).astype(np.float32),
            "y": rng.integers(0, classes, (S, H, m, 8))}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


def _toy_run(merger, Ws, wire=None, opt_name="adamw", seed=0, glob=None,
             state=None):
    m = Ws.shape[1]
    init_params, loss_fn = _toy()
    opt = make_optimizer(opt_name, 1e-2)
    if state is None:
        state, spec = dsgd.init_panel_state(init_params, opt, m, 0,
                                            device="cpu", wire=wire,
                                            merger=merger)
    else:
        state, spec = state
    seg = dsgd.make_panel_segment(loss_fn, opt, 2, spec)
    out, mets = seg(state, _toy_batches(len(Ws), 2, m, seed=seed), Ws,
                    rng=1, global_rounds=glob)
    return out, mets, spec


@pytest.mark.parametrize("name", NON_UNIFORM)
def test_segment_nonuniform_operator_end_to_end(name):
    m = 4
    Ws = np.stack([random_matching(m, 1.0, np.random.default_rng(0)),
                   np.full((m, m), 1.0 / m)]).astype(np.float32)
    out, mets, spec = _toy_run(name, Ws)
    assert float(mets["consensus"][-1]) == 0.0
    x = out["panel"]["float32"]
    assert torch.equal(x, x[:1].expand_as(x))
    assert bool(torch.all(torch.isfinite(x)))
    mg = merging.get_merger(name)
    if mg.stat_panels:
        assert sorted(out["merge_stat"]) == sorted(mg.stat_panels)
        assert any(bool(torch.any(v != 0.0)) for s in
                   out["merge_stat"].values() for v in s.values())
    else:
        assert "merge_stat" not in out


@pytest.mark.parametrize("name", NON_UNIFORM)
def test_segment_merge_matches_merge_stacked_on_premerge_state(name):
    """The engine's global round equals the tree-path oracle on the
    engine's own pre-merge state (the same round run with W = I), and
    TIES differs from the uniform mean there."""
    m = 4
    init_params, _ = _toy()
    opt = make_optimizer("adamw", 1e-2)
    st0, spec = dsgd.init_panel_state(init_params, opt, m, 0, device="cpu",
                                      merger=name)
    W1 = random_matching(m, 1.0, np.random.default_rng(5)).astype(
        np.float32)[None]
    st1, _, _ = _toy_run(name, W1, state=(st0, spec), seed=5)
    pre, _, _ = _toy_run(name, np.eye(m, dtype=np.float32)[None],
                         state=(_clone(st1), spec), seed=6)
    post, mets, _ = _toy_run(name, np.full((1, m, m), 1.0 / m, np.float32),
                             state=(_clone(st1), spec), seed=6)
    assert float(mets["consensus"][0]) == 0.0
    tree = panel.from_panel(pre["panel"], spec)
    oracle = merge_mod.merge_stacked(tree, merger=name,
                                     stats=pre.get("merge_stat"))
    got = panel.from_panel({k: v[0] for k, v in post["panel"].items()},
                           spec)
    for k in ("w", "b"):
        assert torch.equal(got[k], oracle[k]), k
    if name == "ties":
        uni = merge_mod.merge_stacked(tree)
        assert max(float(torch.max(torch.abs(oracle[k] - uni[k])))
                   for k in ("w", "b")) > 1e-4


def test_segment_uniform_merger_bitexact_vs_premerge_engine():
    m = 4
    rng = np.random.default_rng(3)
    Ws = np.stack([random_matching(m, 0.8, rng), np.eye(m),
                   np.full((m, m), 1.0 / m)]).astype(np.float32)
    base, base_mets, _ = _toy_run(None, Ws)
    uni, uni_mets, _ = _toy_run("uniform", Ws)
    for k in base["panel"]:
        assert (base["panel"][k].numpy().tobytes()
                == uni["panel"][k].numpy().tobytes())
    for k in base_mets:
        assert torch.equal(base_mets[k], uni_mets[k])
    assert "merge_stat" not in uni


def test_global_rounds_mask_overrides_w_fingerprint():
    """At m = 2 a matched pair's W IS the 1/m average: the mask, not the
    fingerprint, decides whether the operator runs."""
    W = np.full((1, 2, 2), 0.5, np.float32)
    base, _, _ = _toy_run(None, W, opt_name="sgd")
    gossip, _, _ = _toy_run("ties", W, opt_name="sgd",
                            glob=np.asarray([False]))
    assert torch.equal(base["panel"]["float32"], gossip["panel"]["float32"])
    merged, mets, _ = _toy_run("ties", W, opt_name="sgd",
                               glob=np.asarray([True]))
    x = merged["panel"]["float32"]
    assert torch.equal(x[0], x[1]) and float(mets["consensus"][0]) == 0.0
    assert bool(torch.any(x != base["panel"]["float32"]))
    # without the mask the fingerprint routes the pair through ties too
    fp, _, _ = _toy_run("ties", W, opt_name="sgd")
    assert torch.equal(fp["panel"]["float32"], x)
    with pytest.raises(ValueError, match="global_rounds"):
        _toy_run("ties", W, glob=np.asarray([True, False]))


def test_segment_stats_merger_requires_state():
    m = 4
    init_params, loss_fn = _toy()
    opt = make_optimizer("sgd", 1e-2)
    st, spec = dsgd.init_panel_state(init_params, opt, m, 0, device="cpu")
    seg = dsgd.make_panel_segment(loss_fn, opt, 2,
                                  panel.with_merger(spec, "fisher"))
    with pytest.raises(ValueError, match="merge_stat"):
        seg(st, _toy_batches(1, 2, m), np.full((1, m, m), 0.25, np.float32))


def test_swa_merge_skips_the_parameter_wire():
    x = _t(_panel(4, 24, 13))
    spec = panel.with_wire(panel.make_spec({"w": x}), "int8_ef")
    mg = merging.get_merger("swa")
    stats = mg.init_stats({"float32": x})
    e0 = {"float32": torch.full_like(x, 0.01)}
    # no generator: an int8 encode would raise; the swa merge does not
    mixed, row, e1 = merging.merge_panel({"float32": x}, mg, stats=stats,
                                         spec=spec, err=e0)
    assert e1["float32"] is e0["float32"]
    assert torch.equal(e1["float32"], torch.full_like(x, 0.01))
    torch.testing.assert_close(row["float32"], torch.mean(x, 0), atol=1e-6,
                               rtol=0)
    assert torch.equal(mixed["float32"],
                       row["float32"][None].expand_as(x))
    with pytest.raises(ValueError, match="stochastic"):
        merging.merge_panel({"float32": x}, "ties", spec=spec, err=e0)


def test_segment_wire_codec_composes_with_merger():
    m = 4
    Ws = np.stack([random_matching(m, 1.0, np.random.default_rng(0)),
                   np.full((m, m), 1.0 / m)]).astype(np.float32)
    out, mets, _ = _toy_run("fisher", Ws, wire="int8_ef")
    assert float(mets["consensus"][-1]) == 0.0
    assert any(bool(torch.any(v != 0.0)) for v in out["wire_err"].values())
    x = out["panel"]["float32"]
    assert torch.equal(x, x[:1].expand_as(x))


def test_counterfactual_eval_does_not_modify_state():
    theta = {"x": _t(_panel(6, 23, 9))}
    before = theta["x"].clone()
    for name in ("uniform", "ties", "weighted"):
        merge_mod.counterfactual_eval(lambda p: float(torch.sum(p["x"])),
                                      theta, merger=name)
    assert torch.equal(theta["x"], before)


def test_tree_merges_match_reference():
    x = _panel(5, 12, 4)
    theta = {"a": _t(x[:, :7]), "b": _t(x[:, 7:].reshape(5, 5))}
    jtheta = jax.tree.map(lambda v: jnp.asarray(v.numpy()), theta)
    w = np.asarray([1.0, 2.0, 0.5, 3.0, 1.5], np.float32)
    got = merge_mod.weighted_merge(theta, w)
    want = ref_merge.weighted_merge(jtheta, w)
    for k in theta:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=1e-6,
                                   atol=1e-6)
    for name in ("uniform", "ties", "weighted"):
        got = merge_mod.merge_stacked(theta, merger=name)
        want = ref_merge.merge_stacked(jtheta, merger=name)
        for k in theta:
            np.testing.assert_allclose(got[k].numpy(), _np(want[k]),
                                       rtol=1e-6, atol=1e-6)
    got = merge_mod.uniform_merge(theta)
    for k in theta:
        np.testing.assert_allclose(
            got[k].numpy(), theta[k].numpy().astype(np.float64).mean(0),
            rtol=1e-6, atol=1e-6)
