"""Parameter groups of other dtypes than float32 (bfloat16, float16, int32)
in the port's panel engine, against the JAX package.

Inputs are made with numpy (or, for ``tests/test_panel.py``'s mixed tree,
by the reference's own ``jax.random`` draw) and handed to both packages.

* The spec and the panel of a mixed tree (float32, bfloat16, float16,
  int32 leaves, after ``tests/test_panel_props.py``) equal the reference's:
  groups, offsets, panel bits, and the round trip is exact.
* The communication ops on ``tests/test_panel.py``'s mixed tree against the
  jitted reference: float32 groups within 1e-6, a bfloat16 group's rows
  within one bfloat16 ulp (its float32 sums are taken in another order and
  can round to the neighbouring bfloat16 value; at most 1 % of the
  entries; 1e-6 absolute where a sum cancels to near 0), the same for
  every group's rows on the bfloat16 wire, the float32 means and merged rows within 1e-6, Xi within 1e-5
  relative; the pairwise mix bit for bit with the eager reference (the
  port follows the eager rule, ROADMAP C). An int32 group with power-of-two
  weights is truncated back exactly as the reference's ``astype``.
* AdamW on a bfloat16 group: the moments, and the parameters rounded to
  bfloat16, bit for bit with the jitted reference (its products rounded to
  bfloat16, their sum taken in float32 and used unrounded by the update;
  the eager reference updates from the rounded moments instead). float16:
  the moments and the parameters rounded to float16 bit for bit with the
  eager reference; the jitted reference keeps float16 products in float32,
  so its second moments of 1e-7 and less differ from the stored ones and
  its parameters move by up to 2.5e4 on this input: no oracle there
  (ROADMAP C).
* The int8_ef and topk codecs on a bfloat16 group, with the reference's
  uniforms: view, back(view) and residual or mirror bit for bit.
* A reduced() olmo-1b segment with ``param_dtype="bfloat16"``: the
  reference's ``make_panel_segment`` cannot carry the group (its AdamW
  update promotes it to float32: a TypeError, ROADMAP C), so the oracle is
  the reference's own functions jitted step by step with that one cast
  back: loss, grad norm, Xi and the evals within 5e-3 relative (bfloat16
  forward and backward in two frameworks, products rounded in other
  orders: under one bfloat16 ulp, 7.8e-3; measured at most 2.9e-4 on the
  loss, 1.5e-3 on the grad norm, 3.7e-4 on Xi, 3.4e-4 on the evals);
  after the final merge the rows are identical and ``consensus_distance``
  reads exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.core import dsgd as ref_dsgd
from repro.core import panel as ref_panel
from repro.core import topology
from repro.optim import make_optimizer as ref_make_optimizer
from repro.wire import codec as ref_codec
from repro_torch import wire
from repro_torch.core import panel
from repro_torch.optim import make_optimizer

DTYPES = ["float32", "bfloat16", "float16", "int32"]


def _t(a):
    """A tensor of a numpy / JAX array, bfloat16 moved as its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    """numpy view of a tensor; bfloat16 as JAX's numpy bfloat16."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(jnp.bfloat16)
    return x.numpy()


def _same_bits(a, b):
    a = _np(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _ulp(v, bits):
    """One ulp at |v| of a format with ``bits`` significant bits."""
    _, e = np.frexp(np.abs(np.asarray(v, np.float32)))
    return np.ldexp(np.float32(1.0), e - bits)


def _within_ulp(got, want, bits, share=1e-2, atol=1e-6):
    """Within one ulp of the format (or ``atol``, for sums that cancel to
    near 0), and equal but for at most ``share`` of the entries."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.all(np.abs(got - want)
                  <= np.maximum(_ulp(want, bits), _ulp(got, bits)) + atol)
    assert np.mean(got != want) <= share


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.to(torch.float32).numpy()


def _build_tree(m, shapes, dtypes, seed):
    """tests/test_panel_props.py's mixed tree, as numpy arrays."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i, shp in enumerate(shapes):
        dt = dtypes[i % len(dtypes)]
        if dt == "int32":
            arr = rng.integers(-100, 100, size=(m,) + shp).astype(np.int32)
        else:
            arr = rng.normal(size=(m,) + shp).astype(np.float32)
        tree[f"leaf{i}"] = np.asarray(jnp.asarray(arr).astype(dt))
    return tree


TREES = [(3, [(2, 3), (5,), (), (4, 1)], DTYPES, 0),
         (5, [(7,), (1, 2), (3,), (2, 2), (6,)], ["bfloat16", "int32",
                                                  "float16", "float32",
                                                  "bfloat16"], 1),
         (1, [(2,), (3,)], ["float16", "float16"], 2)]


@pytest.mark.parametrize("case", range(len(TREES)))
def test_mixed_spec_and_roundtrip_match_reference(case):
    m, shapes, dtypes, seed = TREES[case]
    tree = _build_tree(m, shapes, dtypes, seed)
    rspec = ref_panel.make_spec({k: jnp.asarray(v) for k, v in tree.items()})
    rpan = ref_panel.to_panel({k: jnp.asarray(v) for k, v in tree.items()},
                              rspec)
    ttree = {k: _t(v) for k, v in tree.items()}
    spec = panel.make_spec(ttree)
    assert spec.groups == rspec.groups and spec.rows == rspec.rows == m
    assert [(ls.group, ls.offset, ls.size, ls.shape, ls.dtype)
            for ls in spec.leaves] == [
        (ls.group, ls.offset, ls.size, ls.shape, ls.dtype)
        for ls in rspec.leaves]
    pan = panel.to_panel(ttree, spec)
    assert set(pan) == set(rpan)
    for k in pan:
        _same_bits(pan[k], rpan[k])
    back = panel.from_panel(pan, spec)
    for k, v in ttree.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    # each group pays its own itemsize, on the wire and in the moments
    assert spec.wire_total_bytes == rspec.wire_total_bytes
    assert spec.storage_bytes("moments") == rspec.storage_bytes("moments")
    assert spec.storage_bytes("stats", "float32") == rspec.storage_bytes(
        "stats", "float32")


def _mixed_tree(m=8, seed=0):
    """tests/test_panel.py's _mixed_tree (the reference's draw)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {"w": jax.random.normal(ks[0], (m, 17, 5)),
            "emb": jax.random.normal(ks[1], (m, 33), jnp.bfloat16),
            "nest": {"b": jax.random.normal(ks[2], (m, 9))}}


def _both(seed=0):
    tree = _mixed_tree(seed=seed)
    rspec = ref_panel.make_spec(tree)
    rpan = ref_panel.to_panel(tree, rspec)
    return rpan, {k: _t(v) for k, v in rpan.items()}


def _close(got, want, bf16_wire=False):
    """{group: panel} of the port against the reference's: float32 groups
    within 1e-6, bfloat16 groups (and every group on the bfloat16 wire,
    whose rows are rounded through bfloat16) within one bfloat16 ulp."""
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == getattr(torch, str(np.asarray(want[k]).dtype))
        if k == "bfloat16" or bf16_wire:
            _within_ulp(_f32(got[k]), _f32(want[k]), 8)
        else:
            np.testing.assert_allclose(_f32(got[k]), _f32(want[k]),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("wire_dtype", [None, "bfloat16"])
def test_dense_mix_and_mean_on_mixed_tree(wire_dtype):
    rpan, pan = _both(1)
    W = topology.ring(8).astype(np.float32)
    jw = None if wire_dtype is None else jnp.bfloat16
    r_mix = jax.jit(lambda p: ref_panel.mix_dense(p, jnp.asarray(W),
                                                  wire_dtype=jw))(rpan)
    bf = wire_dtype is not None
    _close(panel.mix_dense(pan, W, wire_dtype=wire_dtype), r_mix, bf)
    r_mixed, r_mean, _ = jax.jit(lambda p: ref_panel.mix_dense_mean(
        p, jnp.asarray(W), wire_dtype=jw))(rpan)
    mixed, mean, _ = panel.mix_dense_mean(pan, W, wire_dtype=wire_dtype)
    _close(mixed, r_mixed, bf)
    for k in mean:
        assert mean[k].dtype == torch.float32
        np.testing.assert_allclose(mean[k].numpy(), np.asarray(r_mean[k]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(panel.consensus_from_mean(mixed, mean)),
        float(ref_panel.consensus_from_mean(r_mixed, r_mean)), rtol=1e-5)


def test_pairwise_global_merge_merged_and_xi_on_mixed_tree():
    rpan, pan = _both(2)
    partner = topology.partner_array(
        topology.random_matching(8, 0.7, np.random.default_rng(3)))
    # the pairwise mix follows the eager rule (bfloat16 scalars, each
    # operation rounded): bit for bit with the eager reference
    with jax.disable_jit():
        r_pair = ref_panel.mix_pairwise(rpan, jnp.asarray(partner))
    got = panel.mix_pairwise(pan, partner)
    for k in got:
        _same_bits(got[k], r_pair[k])
    r_gm = jax.jit(ref_panel.global_merge)(rpan)
    gm = panel.global_merge(pan)
    _close(gm, r_gm)
    for k in gm:  # every row the same merged row
        assert torch.equal(gm[k], gm[k][:1].expand(gm[k].shape))
    r_merged = jax.jit(ref_panel.merged)(rpan)
    merged = panel.merged(pan)
    for k in merged:
        assert merged[k].dtype == torch.float32
        np.testing.assert_allclose(merged[k].numpy(),
                                   np.asarray(r_merged[k]), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        float(panel.consensus_distance(pan)),
        float(jax.jit(ref_panel.consensus_distance)(rpan)), rtol=1e-5)
    # identical bfloat16 rows sum exactly in float32: Xi is 0; a float32
    # group's mean of 8 equal rows is a few float32 ulps off the row
    assert float(panel.consensus_distance({"bfloat16": gm["bfloat16"]})) \
        == 0.0
    assert float(panel.consensus_distance(gm)) <= 1e-6


def test_float16_and_int32_groups_mix_as_the_reference():
    """A float16 group through the mix and the reduce; an int32 group under
    power-of-two weights, truncated back to int32 exactly."""
    tree = _build_tree(4, [(3, 5), (7,), (2, 3)], ["float16", "int32",
                                                   "float32"], 5)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    rspec = ref_panel.make_spec(jt)
    rpan = ref_panel.to_panel(jt, rspec)
    pan = {k: _t(v) for k, v in rpan.items()}
    W = np.array([[.5, .25, 0, .25], [.25, .5, .25, 0], [0, .25, .5, .25],
                  [.25, 0, .25, .5]], np.float32)
    r_mix = jax.jit(lambda p: ref_panel.mix_dense(p, jnp.asarray(W)))(rpan)
    mix = panel.mix_dense(pan, W)
    _same_bits(mix["int32"], r_mix["int32"])
    _within_ulp(_f32(mix["float16"]), _f32(r_mix["float16"]), 11)
    np.testing.assert_allclose(mix["float32"].numpy(),
                               np.asarray(r_mix["float32"]), rtol=1e-6)
    r_merged = jax.jit(ref_panel.merged)(rpan)
    for k, v in panel.merged(pan).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(r_merged[k]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(panel.consensus_distance(pan)),
        float(jax.jit(ref_panel.consensus_distance)(rpan)), rtol=1e-5)


def _adamw_inputs(dtype, seed=0, m=4, D=20000):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(m, D)), rng.normal(size=(m, D)) * 1e-2,
            rng.normal(size=(m, D)) * 1e-2, rng.normal(size=(m, D)) ** 2
            * 1e-4]
    return [jnp.asarray(a.astype(np.float32)).astype(dtype) for a in arrs]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_adamw_on_a_narrow_group(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bits = 8 if dtype == "bfloat16" else 11
    ref = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                             total_steps=20)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4, total_steps=20)
    P, G, M0, V0 = _adamw_inputs(jdt)
    st = {"m": {"g": M0}, "v": {"g": V0},
          "step_count": jnp.full((4,), 3, jnp.int32)}
    jp, jst = jax.jit(jax.vmap(ref.update))({"g": G}, st, {"g": P})
    with jax.disable_jit():
        ep, est = jax.vmap(ref.update)({"g": G}, st, {"g": P})
    assert jp["g"].dtype == jnp.float32  # the reference's promotion
    pst = {"m": {"g": _t(M0)}, "v": {"g": _t(V0)}, "step_count": 3}
    pp, pst = opt.update({"g": _t(G)}, pst, {"g": _t(P)})
    assert pp["g"].dtype == pst["m"]["g"].dtype == pst["v"]["g"].dtype == tdt
    for k in ("m", "v"):
        _same_bits(pst[k]["g"], est[k]["g"])
    if dtype == "bfloat16":
        for k in ("m", "v"):
            _same_bits(pst[k]["g"], jst[k]["g"])
        _same_bits(pp["g"], jnp.asarray(jp["g"]).astype(jdt))
        return
    # float16: the eager reference's rule
    _same_bits(pp["g"], jnp.asarray(ep["g"]).astype(jdt))



@pytest.mark.parametrize("name", ["int8_ef", "topk"])
def test_codecs_on_a_bfloat16_group(name):
    """The codec decodes to the group's dtype (view and back), its residual
    or mirror float32, with the reference's uniforms."""
    m, D = 5, 333
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((m, D)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    if name == "topk":
        err = np.asarray(x.astype(jnp.float32)) + 0.3 * rng.standard_normal(
            (m, D)).astype(np.float32)
    else:
        err = (0.01 * rng.standard_normal((m, D))).astype(np.float32)
    ref = ref_codec.get_codec(name)
    codec = wire.get_codec(name)
    key = jax.random.PRNGKey(4) if ref.needs_key else None
    u = np.asarray(ref_codec._uniform(key, (m, D))) if ref.needs_key else None
    r_view, r_back, r_err = ref.encode(x, key=key, err=jnp.asarray(err))
    view, back, new_err = codec.encode(
        _t(x), err=_t(err), u=None if u is None else _t(u))
    _same_bits(view, r_view)
    _same_bits(back(view), r_back(r_view))
    _same_bits(new_err, r_err)


# ------------------------------------------------------------- the segment

M, ROUNDS, H, B, SEQ = 4, 3, 2, 2, 16
SEG_RTOL = 5e-3


@pytest.fixture(scope="module")
def bf16_runs():
    from repro.configs import get_config as ref_get_config
    from repro.launch.train import build_cpu_preset as ref_cpu_preset
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.core import dsgd
    from repro_torch.core.schedule import make_schedule
    from repro_torch.data.synthetic import SyntheticLM, make_agent_lm_batches
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.weights import from_reference_params

    ref_cfg = ref_cpu_preset(ref_get_config("olmo-1b"), M).replace(
        param_dtype="bfloat16")
    cfg = train.build_cpu_preset(get_config("olmo-1b"), M).replace(
        param_dtype="bfloat16")
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=ROUNDS * H)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ROUNDS * H)
    ref_state, ref_spec = ref_dsgd.init_panel_state(
        ref_model.init_params, ref_opt, M, jax.random.PRNGKey(0))
    assert ref_spec.groups[0][0] == "bfloat16"
    stacked = jax.tree.map(np.asarray,
                           ref_panel.from_panel(ref_state["panel"], ref_spec))
    params, _, _ = from_reference_params(stacked, device="cpu")
    state, spec = dsgd.panel_state_from_params(params, opt)
    assert spec.groups == ref_spec.groups

    sched = make_schedule("final_merge", M, ROUNDS, prob=0.5, seed=0)
    lm = SyntheticLM(vocab=cfg.vocab_size, num_domains=8, seed=0)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(M, 0.1, seed=1), ROUNDS, H, B, SEQ,
        np.random.default_rng(2))
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(ROUNDS)]).astype(np.float32)
    glob_mix = np.ones(lm.num_domains) / lm.num_domains
    eval_b = {k: v[0] for k, v in make_agent_lm_batches(
        lm, [glob_mix], 2 * B, SEQ, np.random.default_rng(999)).items()}

    # the reference's segment cannot carry a bfloat16 group
    with pytest.raises(TypeError, match="carry"):
        ref_dsgd.make_panel_segment(ref_model.loss_fn, ref_opt, H, ref_spec)(
            jax.tree.map(jnp.copy, ref_state),
            jax.tree.map(jnp.asarray, batches), jnp.asarray(Ws),
            jax.random.PRNGKey(1))

    # the oracle: the reference's functions, jitted, a step at a time
    def losses_grads(pan, batch):
        def one(p, b):
            return jax.value_and_grad(
                lambda q: ref_model.loss_fn(q, b, None)[0])(p)
        return jax.vmap(one)(ref_panel.from_panel(pan, ref_spec), batch)

    lg = jax.jit(losses_grads)
    upd = jax.jit(jax.vmap(ref_opt.update))
    mix = jax.jit(lambda p, W: ref_panel.mix_dense_mean(p, W))
    pan, ropt = ref_state["panel"], ref_state["opt"]
    ref_mets = {"loss": [], "grad_norm": [], "consensus": []}
    for s in range(ROUNDS):
        ls, gs = [], []
        for h in range(H):
            b = {k: jnp.asarray(v[s, h]) for k, v in batches.items()}
            losses, grads = lg(pan, b)
            gpan = ref_panel.to_panel(grads, ref_spec)
            new, ropt = upd(gpan, ropt, pan)
            pan = {k: v.astype(pan[k].dtype) for k, v in new.items()}
            ls.append(float(jnp.mean(losses)))
            gs.append(float(ref_panel.panel_norm(gpan, axis_mean=True)))
        W = Ws[s]
        if np.array_equal(W, np.eye(M, dtype=np.float32)):
            xi = float(jax.jit(ref_panel.consensus_distance)(pan))
        else:
            pan, mean, _ = mix(pan, jnp.asarray(W))
            xi = float(ref_panel.consensus_from_mean(pan, mean))
        ref_mets["loss"].append(np.mean(ls))
        ref_mets["grad_norm"].append(np.mean(gs))
        ref_mets["consensus"].append(xi)
    jb = jax.tree.map(jnp.asarray, eval_b)
    from repro.core import merge as ref_merge
    ref_merged = float(jax.jit(lambda p: ref_merge.counterfactual_eval_panel(
        lambda q: ref_model.loss_fn(q, jb, None)[0], p, ref_spec))(pan))
    ref_local = float(jax.jit(lambda p: jnp.mean(jax.vmap(
        lambda q: ref_model.loss_fn(q, jb, None)[0])(
        ref_panel.from_panel(p, ref_spec))))(pan))

    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
    state, mets = seg(state, batches, Ws)
    tb = train.to_device(eval_b, "cpu")
    merged = train.eval_merged(model.loss_fn, state["panel"], spec, tb)
    local = train.eval_local(model.loss_fn, state["panel"], spec, tb)
    return {"Ws": Ws, "ref": (ref_mets, ref_merged, ref_local),
            "port": ({k: v.numpy() for k, v in mets.items()}, merged, local),
            "state": state}


@pytest.mark.parametrize("metric", ["loss", "grad_norm", "consensus"])
def test_bf16_segment_metrics_match_reference(bf16_runs, metric):
    ref, port = bf16_runs["ref"][0][metric], bf16_runs["port"][0][metric]
    assert port.shape == (ROUNDS,) and np.all(np.isfinite(port))
    np.testing.assert_allclose(port, ref, rtol=SEG_RTOL, atol=1e-6)


def test_bf16_segment_evals_and_final_merge(bf16_runs):
    _, ref_merged, ref_local = bf16_runs["ref"]
    _, merged, local = bf16_runs["port"]
    np.testing.assert_allclose(merged, ref_merged, rtol=SEG_RTOL)
    np.testing.assert_allclose(local, ref_local, rtol=SEG_RTOL)
    x = bf16_runs["state"]["panel"]["bfloat16"]
    assert x.dtype == torch.bfloat16
    assert torch.equal(x, x[:1].expand(x.shape))
    assert float(panel.consensus_distance(bf16_runs["state"]["panel"])) == 0.0
    assert bf16_runs["state"]["opt"]["m"]["bfloat16"].dtype == torch.bfloat16
    assert np.all(bf16_runs["Ws"][-1] == np.float32(1.0 / M))
