"""The port's core machinery of the paper (topology diagnostics, gossip,
consensus, the tree-state driver, the gossip merge) against the JAX
package's.

The first part mirrors ``tests/test_core.py`` on the port, its property
tests run over fixed seeds and sizes (hypothesis is not needed). The second
holds each port function against its reference on the same numpy-made
inputs, the JAX side jitted (with a bf16 payload eagerly: jitted, XLA's
excess precision keeps float32 values where the reference rounds the mixed
rows through bf16, so only the eager reference applies its own rule): the
float32 mixes and means at atol 1e-6 (sums in other orders; a bf16 payload's
rows at one bf16 step, rtol 2^-7, since a float32 sum taken in another order
can land on the other side of a bf16 rounding tie), the per-leaf
int8/int4 payloads bit for bit from the reference's uniforms, the consensus
distance at rtol 1e-6, u_term at rtol 1e-4 (three nested derivatives in
float32), and 10 rounds of the tree-state drivers from handed-over JAX init at rtol 1e-5 per round (loss, grad norm,
consensus; atol 1e-7 for the Xi of merged rows, float32 rounding noise),
their final parameters at 1e-5 (SGD) or 1e-3 (AdamW, a tenth of its
learning rate)."""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import make_problem as ref_make_problem
from repro import wire as ref_wire
from repro.core import consensus as ref_consensus
from repro.core import dsgd as ref_dsgd
from repro.core import gossip as ref_gossip
from repro.core import panel as ref_panel
from repro.core import topology as ref_topo
from repro.core.merge import gossip_merge_rounds as ref_gossip_merge_rounds
from repro.core.schedule import make_schedule as ref_make_schedule
from repro.data.synthetic import make_agent_batches
from repro.optim import make_optimizer as ref_make_optimizer
from repro.wire import codec as ref_codec
from repro_torch import wire
from repro_torch.bench.common import make_problem
from repro_torch.core import consensus, dsgd, gossip, panel
from repro_torch.core import topology as topo
from repro_torch.core.merge import gossip_merge_rounds, weighted_merge
from repro_torch.core.schedule import make_schedule
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_flatten

M = 8


def _t(tree):
    """A numpy/JAX tree as CPU torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


BF16_STEP = 2.0 ** -7  # one bf16 step, relative to the value


def _close(ours, ref, atol=1e-6, rtol=1e-6):
    a, b = tree_flatten(ours)[0], jax.tree_util.tree_leaves(ref)
    assert len(a) == len(b)
    for x, r in zip(a, b):
        assert tuple(x.shape) == r.shape
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(r, np.float32), atol=atol,
                                   rtol=rtol)


def _jit(fn, wire_kw):
    """The reference function jitted, or as it is under a bf16 payload
    (see the module docstring)."""
    return fn if wire_kw else jax.jit(fn)


def _tree(seed, m=M, shapes=((13,), (4, 5), (7,))):
    rng = np.random.default_rng(seed)
    return {f"l{i}": rng.standard_normal((m,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


# ----------------------------------------------------- mirrors of test_core


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_random_matching_doubly_stochastic(m):
    for seed, prob in itertools.product(range(10), (0.0, 0.2, 0.5, 1.0)):
        W = topo.random_matching(m, prob, np.random.default_rng(seed))
        assert topo.is_doubly_stochastic(W)


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_named_topologies_doubly_stochastic(m):
    for t in range(21):
        for W in (topo.ring(m), topo.exponential(m),
                  topo.fully_connected(m), topo.exponential_round(m, t)):
            assert topo.is_doubly_stochastic(W)


def test_spectral_p_ordering():
    m = 16
    p_full = topo.spectral_p(topo.fully_connected(m))
    p_ring = topo.spectral_p(topo.ring(m))
    p_id = topo.spectral_p(topo.identity(m))
    assert p_full == pytest.approx(1.0, abs=1e-9)
    assert p_id == pytest.approx(0.0, abs=1e-9)
    assert 0.0 < p_ring < 1.0
    assert p_full > p_ring > p_id


def test_expected_p_random_graph_theta1():
    m = 16
    p = topo.expected_p(topo.make_sampler("random", m, 0.2), m, 400,
                        np.random.default_rng(0))
    assert p > 0.05


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_consensus_contraction_lemma_d1(seed):
    """E||Theta W - bar||^2 <= (1-p) ||Theta - bar||^2 (Assumption 1) for
    the random-matching topology, through the panel-backed mix."""
    m = 8
    rng = np.random.default_rng(seed)
    theta = {"w": torch.as_tensor(rng.normal(size=(m, 40)),
                                  dtype=torch.float32)}
    xi0 = float(consensus.consensus_distance(theta)) ** 2
    xis = []
    for t in range(50):
        W = topo.random_matching(m, 0.5, rng)
        xis.append(float(consensus.consensus_distance(
            gossip.mix_dense(theta, W))) ** 2)
    assert np.mean(xis) < xi0
    for xi in xis:
        assert xi <= xi0 + 1e-5


def test_global_merge_equals_mean():
    m = 4
    theta = {"a": torch.arange(m * 6, dtype=torch.float32).reshape(m, 6)}
    merged = gossip.global_merge(theta)
    mean = theta["a"].mean(0).numpy()
    np.testing.assert_allclose(merged["a"][0].numpy(), mean, atol=1e-6)
    np.testing.assert_allclose(merged["a"][2].numpy(), mean, atol=1e-6)
    densed = gossip.mix_dense(theta, topo.fully_connected(m))
    np.testing.assert_allclose(merged["a"].numpy(), densed["a"].numpy(),
                               atol=1e-6)


def test_pairwise_mix_matches_dense_matching():
    m = 8
    W = topo.random_matching(m, 0.8, np.random.default_rng(3))
    partner = topo.partner_array(W)
    theta = {"x": torch.as_tensor(
        np.random.default_rng(0).standard_normal((m, 13)),
        dtype=torch.float32)}
    a = gossip.mix_dense(theta, W)
    b = gossip.mix_pairwise(theta, partner)
    np.testing.assert_allclose(a["x"].numpy(), b["x"].numpy(), atol=1e-6)


@pytest.mark.parametrize("w", [[0.01, 0.01, 0.01, 10.0], [1.0, 2.0, 3.0, 4.0],
                               [5.0, 0.3, 0.3, 0.01]])
def test_weighted_merge_convexity(w):
    m = 4
    theta = {"x": torch.as_tensor(
        np.random.default_rng(1).standard_normal((m, 7)),
        dtype=torch.float32)}
    out = weighted_merge(theta, w)
    lo = theta["x"].min(0).values - 1e-5
    hi = theta["x"].max(0).values + 1e-5
    assert bool(torch.all(out["x"] >= lo)) and bool(torch.all(out["x"] <= hi))


def test_gossip_merge_rounds_approaches_global_merge():
    """Appendix C.3.4: log2(8) = 3 rounds of exponential gossip give the
    global merge."""
    m = 8
    theta = {"x": torch.as_tensor(
        np.random.default_rng(2).standard_normal((m, 29)),
        dtype=torch.float32)}
    target = gossip.merged_model(theta)
    approx = gossip_merge_rounds(theta, topo.make_sampler("exponential", m),
                                 rounds=3, rng=np.random.default_rng(0))
    err = float(torch.max(torch.abs(approx["x"] - target["x"][None])))
    assert err < 1e-4


def test_dsgd_step_pairwise_impl_takes_partner_array():
    """gossip_impl='pairwise' steps receive the (m,) partner array in the
    W slot."""
    m = 4

    def init_params(gen):
        return {"w": torch.randn(3, generator=gen)}

    def loss_fn(p, batch, rng=None):
        return torch.sum(torch.square(p["w"])), {}

    opt = make_optimizer("sgd", 0.0, weight_decay=0.0, momentum=0.0)
    state = dsgd.init_state(init_params, opt, m,
                            torch.Generator().manual_seed(0))
    before = {"w": state["params"]["w"].clone()}
    step = dsgd.make_dsgd_step(loss_fn, opt, gossip_impl="pairwise")
    W = topo.random_matching(m, 1.0, np.random.default_rng(0))
    partner = topo.partner_array(W)
    new_state, mets = step(state, torch.zeros((m, 1)), partner)
    # lr = 0: the local step is a no-op, so the result IS the pairwise mix
    ref = gossip.mix_pairwise_tree(before, partner)
    np.testing.assert_allclose(new_state["params"]["w"].numpy(),
                               ref["w"].numpy(), atol=1e-6)
    assert bool(torch.isfinite(mets["loss"]))


def test_schedules_place_global_rounds_correctly():
    m, T = 8, 50
    s = make_schedule("final_merge", m, T)
    assert not s.is_global(0) and not s.is_global(T - 2)
    assert s.is_global(T - 1)
    w = make_schedule("windowed", m, T, start=10, end=15)
    assert w.is_global(12) and not w.is_global(15)
    p = make_schedule("periodic", m, T, period=10)
    assert p.is_global(9) and p.is_global(19) and not p.is_global(10)


def test_schedule_costs_match_paper_cost_model():
    m, T = 16, 100
    s = make_schedule("final_merge", m, T, prob=0.2, seed=0)
    costs = [s.round_cost(s.mixing_matrix(t)) for t in range(T)]
    assert costs[-1] == 2.0
    assert 0.05 < np.mean(costs[:-1]) < 0.4


def _quartic(p, batch=None):
    x = p["x"]
    return torch.sum(x ** 4) + 0.1 * torch.sum(x ** 2), {}


def _quartic_params(m=4):
    return {"x": torch.stack([torch.tensor([1.0 + 0.1 * k, -1.0])
                              for k in range(m)])}


def test_u_term_negative_under_progressive_sharpening():
    """The U-term estimator on a quartic loss gives a finite scalar."""
    u = consensus.u_term(_quartic, _quartic_params(), None)
    assert bool(torch.isfinite(u))


# --------------------------------------------------- parity: gossip, panel


@pytest.mark.parametrize("wire_kw", [{}, {"wire_dtype": "bf16"},
                                     {"wire": "bf16"}])
def test_panel_backed_gossip_matches(wire_kw):
    close = functools.partial(_close,
                              rtol=BF16_STEP if wire_kw else 1e-6)
    x = _tree(5)
    ref_kw = {k: (jnp.bfloat16 if v == "bf16" and k == "wire_dtype" else v)
              for k, v in wire_kw.items()}
    kw = {k: (torch.bfloat16 if v == "bf16" and k == "wire_dtype" else v)
          for k, v in wire_kw.items()}
    W = topo.random_matching(M, 0.8, np.random.default_rng(5))
    Wf = topo.fully_connected(M)
    partner = topo.partner_array(W)
    jx = jax.tree.map(jnp.asarray, x)
    for Wi in (W, Wf):
        close(gossip.mix_dense(_t(x), Wi, **kw), jax.jit(
            lambda p, w: ref_gossip.mix_dense(p, w, **ref_kw))(
                jx, jnp.asarray(Wi, jnp.float32)))
    close(gossip.mix_pairwise(_t(x), partner, **kw), _jit(
        lambda p, q: ref_gossip.mix_pairwise(p, q, **ref_kw), wire_kw)(
            jx, jnp.asarray(partner, jnp.int32)))
    close(gossip.global_merge(_t(x), **kw), _jit(
        lambda p: ref_gossip.global_merge(p, **ref_kw), wire_kw)(jx))
    close(gossip.merged_model(_t(x)), jax.jit(ref_gossip.merged_model)(jx))


@pytest.mark.parametrize("wire_kw", [{}, {"wire_dtype": "bf16"},
                                     {"wire": "bf16"}])
@pytest.mark.parametrize("topology", ["matching", "full", "identity"])
def test_tree_gossip_matches(wire_kw, topology):
    close = functools.partial(_close,
                              rtol=BF16_STEP if wire_kw else 1e-6)
    x = _tree(6)
    ref_kw = {k: (jnp.bfloat16 if v == "bf16" and k == "wire_dtype" else v)
              for k, v in wire_kw.items()}
    kw = {k: (torch.bfloat16 if v == "bf16" and k == "wire_dtype" else v)
          for k, v in wire_kw.items()}
    W = {"matching": topo.random_matching(M, 0.7, np.random.default_rng(6)),
         "full": topo.fully_connected(M),
         "identity": topo.identity(M)}[topology]
    partner = topo.partner_array(W)
    jx = jax.tree.map(jnp.asarray, x)
    close(gossip.mix_dense_tree(_t(x), W, **kw), _jit(
        lambda p, w: ref_gossip.mix_dense_tree(p, w, **ref_kw), wire_kw)(
            jx, jnp.asarray(W, jnp.float32)))
    close(gossip.mix_pairwise_tree(_t(x), partner, 0.3, **kw), _jit(
        lambda p, q: ref_gossip.mix_pairwise_tree(p, q, 0.3, **ref_kw),
        wire_kw)(
            jx, jnp.asarray(partner, jnp.int32)))
    live = np.array([True, False, True, True, False, True, True, True])
    for lv in (None, live):
        ref_lv = None if lv is None else jnp.asarray(lv)
        close(gossip.global_merge_tree(_t(x), live=lv, **kw), _jit(
            lambda p: ref_gossip.global_merge_tree(p, live=ref_lv,
                                                   **ref_kw), wire_kw)(jx))
        close(gossip.merged_model_tree(_t(x), live=lv), jax.jit(
            lambda p: ref_gossip.merged_model_tree(p, live=ref_lv))(jx))


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_tree_gossip_quantized_from_reference_uniforms(name):
    """int8/int4 per leaf: each leaf's payload bit for bit from the
    reference's uniforms (its key folded by leaf index), the mixes at atol
    1e-6, idle rows untouched."""
    x = _tree(7, shapes=((300,), (3, 50), (7,)))
    jx = jax.tree.map(jnp.asarray, x)
    key = jax.random.PRNGKey(11)
    leaves = jax.tree_util.tree_leaves(jx)
    u = [torch.as_tensor(np.array(ref_codec._uniform(
        jax.random.fold_in(key, i), (M, int(np.prod(v.shape[1:]))))))
        for i, v in enumerate(leaves)]
    codec, ref_c = wire.get_codec(name), ref_wire.get_codec(name)
    for i, v in enumerate(leaves):
        rv, _ = ref_gossip._encode_leaf(ref_c, v, key, i)
        ov, _ = gossip._encode_leaf(codec, _t(np.asarray(v)), None, u[i])
        assert ov.numpy().tobytes() == np.asarray(rv).tobytes()
    W = topo.random_matching(M, 0.6, np.random.default_rng(7))
    partner = topo.partner_array(W)
    ours = gossip.mix_dense_tree(_t(x), W, wire=name, u=u)
    _close(ours, ref_gossip.mix_dense_tree(jx, jnp.asarray(W, jnp.float32),
                                           wire=name, key=key))
    idle = np.flatnonzero(partner == np.arange(M))
    for k, v in ours.items():
        assert torch.equal(v[idle], _t(x[k])[idle])
    _close(gossip.mix_pairwise_tree(_t(x), partner, wire=name, u=u),
           ref_gossip.mix_pairwise_tree(jx, jnp.asarray(partner), wire=name,
                                        key=key))
    _close(gossip.global_merge_tree(_t(x), wire=name, u=u),
           ref_gossip.global_merge_tree(jx, wire=name, key=key))


def test_stateful_codecs_refused():
    x = _t(_tree(8))
    W = topo.fully_connected(M)
    for name in ("int8_ef", "int4_ef", "topk"):
        with pytest.raises(ValueError, match="error-feedback"):
            gossip.mix_dense(x, W, wire=name)
        with pytest.raises(ValueError, match="error-feedback"):
            gossip.mix_dense_tree(x, W, wire=name)
        with pytest.raises(ValueError, match="error-feedback"):
            gossip_merge_rounds(x, topo.make_sampler("exponential", M), 1,
                                np.random.default_rng(0), wire=name)
        with pytest.raises(ValueError, match="error-feedback"):
            dsgd.make_dsgd_step(lambda p, b, r: (0, {}),
                                make_optimizer("sgd", 0.1), wire=name)
    with pytest.raises(ValueError, match="not both"):
        gossip.mix_dense_tree(x, W, wire_dtype=torch.bfloat16, wire="bf16")
    with pytest.raises(ValueError, match="gen="):
        gossip.mix_dense_tree(x, W, wire="int8")


@pytest.mark.parametrize("wire_kw", [{}, {"wire_dtype": "bf16"}])
def test_panel_mix_pairwise_and_merged_tree_match(wire_kw):
    close = functools.partial(_close,
                              rtol=BF16_STEP if wire_kw else 1e-6)
    x = _tree(9)
    ref_spec = ref_panel.make_spec(jax.tree.map(jnp.asarray, x))
    spec = panel.make_spec(_t(x))
    ref_pan = ref_panel.to_panel(jax.tree.map(jnp.asarray, x), ref_spec)
    pan = panel.to_panel(_t(x), spec)
    ref_kw = {k: jnp.bfloat16 for k in wire_kw}
    kw = {k: torch.bfloat16 for k in wire_kw}
    partner = topo.partner_array(topo.random_matching(
        M, 0.6, np.random.default_rng(9)))
    got = panel.mix_pairwise(pan, partner, 0.25, **kw)
    ref = _jit(lambda p, q: ref_panel.mix_pairwise(p, q, 0.25, **ref_kw),
               wire_kw)(
        ref_pan, jnp.asarray(partner))
    close(got, ref)
    for r in np.flatnonzero(partner == np.arange(M)):
        assert torch.equal(got["float32"][r], pan["float32"][r])
    W = topo.random_matching(M, 0.6, np.random.default_rng(10))
    close(panel.mix_dense(pan, W, **kw), _jit(
        lambda p, w: ref_panel.mix_dense(p, w, **ref_kw), wire_kw)(
            ref_pan, jnp.asarray(W, jnp.float32)))
    mixed, mean, _ = panel.mix_dense_mean(pan, W, **kw)
    r_mixed, r_mean, _ = _jit(
        lambda p, w: ref_panel.mix_dense_mean(p, w, **ref_kw), wire_kw)(
            ref_pan, jnp.asarray(W, jnp.float32))
    close(mixed, r_mixed)
    close(mean, r_mean)
    close(panel.global_merge(pan, **kw), _jit(
        lambda p: ref_panel.global_merge(p, **ref_kw), wire_kw)(ref_pan))
    close(panel.merged_tree(pan, spec),
           jax.jit(lambda p: ref_panel.merged_tree(p, ref_spec))(ref_pan))
    with pytest.raises(ValueError, match="not both"):
        panel.mix_pairwise(pan, partner, spec=panel.with_wire(spec, "bf16"),
                           wire_dtype=torch.bfloat16)


@pytest.mark.parametrize("name", ["int8_ef", "topk"])
def test_panel_mix_pairwise_error_feedback_matches(name):
    """mix_pairwise with err=: a round-to-nearest int8_ef (residual) and
    topk (mirror, the delta form) against the reference's, idle rows and
    their error-feedback rows untouched."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((M, 333)).astype(np.float32)
    if name == "topk":
        err = x + 0.3 * rng.standard_normal((M, 333)).astype(np.float32)
        codec, ref_c = wire.get_codec("topk"), ref_wire.get_codec("topk")
    else:
        err = (0.01 * rng.standard_normal((M, 333))).astype(np.float32)
        codec = wire.Int8Codec("int8_ef", stochastic=False,
                               error_feedback=True)
        ref_c = ref_codec.Int8Codec("int8_ef", stochastic=False,
                                    error_feedback=True)
    spec = panel.with_wire(panel.make_spec({"w": _t(x)}),
                           {"float32": codec})
    ref_spec = ref_panel.with_wire(ref_panel.make_spec(
        {"w": jnp.asarray(x)}), {"float32": ref_c})
    partner = topo.partner_array(topo.random_matching(
        M, 0.6, np.random.default_rng(13)))
    got, got_err = panel.mix_pairwise({"float32": _t(x)}, partner, spec=spec,
                                      err={"float32": _t(err)})
    ref, ref_err = ref_panel.mix_pairwise(
        {"float32": jnp.asarray(x)}, jnp.asarray(partner), spec=ref_spec,
        err={"float32": jnp.asarray(err)})
    _close(got, ref)
    _close(got_err, ref_err)
    for r in np.flatnonzero(partner == np.arange(M)):
        assert np.array_equal(got["float32"][r].numpy(), x[r])
        assert np.array_equal(got_err["float32"][r].numpy(), err[r])


# ------------------------------------------------ parity: consensus, merge


def test_consensus_matches():
    x = _tree(14)
    jx = jax.tree.map(jnp.asarray, x)
    ref_xi = float(jax.jit(ref_consensus.consensus_distance)(jx))
    np.testing.assert_allclose(float(consensus.consensus_distance(_t(x))),
                               ref_xi, rtol=1e-6)
    np.testing.assert_allclose(
        float(consensus.consensus_distance_tree(_t(x))),
        float(jax.jit(ref_consensus.consensus_distance_tree)(jx)), rtol=1e-6)
    np.testing.assert_allclose(float(consensus.gamma_trace(_t(x))),
                               float(jax.jit(ref_consensus.gamma_trace)(jx)),
                               rtol=1e-6)


def test_gossip_merge_rounds_matches():
    x = _tree(15)
    jx = jax.tree.map(jnp.asarray, x)
    for kind, rounds in (("exponential", 3), ("random", 4)):
        sampler, ref_sampler = (topo.make_sampler(kind, M, 0.5),
                                ref_topo.make_sampler(kind, M, 0.5))
        got, xis = gossip_merge_rounds(_t(x), sampler, rounds,
                                       np.random.default_rng(1),
                                       return_xi=True)
        ref, ref_xis = ref_gossip_merge_rounds(jx, ref_sampler, rounds,
                                               np.random.default_rng(1),
                                               return_xi=True)
        _close(got, ref)
        np.testing.assert_allclose(xis.numpy(), np.asarray(ref_xis),
                                   rtol=1e-5, atol=1e-6)


def _mlp(seed=0, m=M):
    """The figure harness's MLP problem in both packages, the port's init
    handed over from the reference (the rows of jax.vmap(init) over
    split(PRNGKey(0), m), returned in turn)."""
    ds, parts, r_init, r_loss, r_acc = ref_make_problem(seed)
    _, _, _, loss, acc = make_problem(seed, device="cpu")
    stacked = jax.vmap(r_init)(jax.random.split(jax.random.PRNGKey(0), m))
    rows = [{k: torch.as_tensor(np.array(v[i])) for k, v in stacked.items()}
            for i in range(m)]
    it = itertools.cycle(rows)
    return ds, parts, (r_init, r_loss, r_acc, stacked), (
        lambda gen: next(it), loss, acc)


def test_u_term_matches():
    """u_term on the quartic problem and on the MLP at batch 16 (4
    agents), rtol 1e-4."""
    q = _quartic_params()
    ref_q = ref_consensus.u_term(
        lambda p, b: (jnp.sum(p["x"] ** 4) + 0.1 * jnp.sum(p["x"] ** 2), {}),
        {"x": jnp.asarray(q["x"].numpy())}, None)
    np.testing.assert_allclose(float(consensus.u_term(_quartic, q, None)),
                               float(ref_q), rtol=1e-4)
    ds, parts, (_, r_loss, _, stacked), (_, loss, _) = _mlp(0, m=4)
    xb, yb = make_agent_batches(ds, parts, 16, np.random.default_rng(0))
    batch = (xb[0], yb[0])
    ref_u = jax.jit(lambda p, b: ref_consensus.u_term(r_loss, p, b))(
        stacked, (jnp.asarray(batch[0]), jnp.asarray(batch[1])))
    got = consensus.u_term(loss, _t(stacked), (torch.as_tensor(batch[0]),
                                               torch.as_tensor(batch[1])))
    assert float(ref_u) != 0.0
    np.testing.assert_allclose(float(got), float(ref_u), rtol=1e-4)


def test_mergeability_gap_matches():
    _, _, (_, _, r_acc, stacked), (_, _, acc) = _mlp(1)
    ref = jax.jit(lambda p: ref_consensus.mergeability_gap(r_acc, p))(
        stacked)
    got = consensus.mergeability_gap(acc, _t(stacked))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)


# ------------------------------------------- parity: the tree-state driver


def _drive(kind, rounds=10, seed=0):
    """10 rounds of the MLP problem in both packages from one handed-over
    init, one batch stream and one W stream: per-round metrics of each."""
    ds, parts, (r_init, r_loss, _, _), (init, loss, _) = _mlp(seed)
    H = 3 if kind == "round" else 1
    if kind == "round":
        ref_opt = ref_make_optimizer("adamw", 1e-2, weight_decay=5e-4)
        opt = make_optimizer("adamw", 1e-2, weight_decay=5e-4)
    else:
        ref_opt = ref_make_optimizer("sgd", 0.1, weight_decay=0.0)
        opt = make_optimizer("sgd", 0.1, weight_decay=0.0)
    sched_name = "final_merge" if kind == "round" else "constant"
    ref_sched = ref_make_schedule(sched_name, M, rounds, prob=0.3, seed=seed)
    sched = make_schedule(sched_name, M, rounds, prob=0.3, seed=seed)
    if kind == "parallel":
        # the port's handed-over callable returns agent 0's row first: the
        # reference's row of split(PRNGKey(0), M)[0]
        r_state = ref_dsgd.init_parallel_state(
            r_init, ref_opt, jax.random.split(jax.random.PRNGKey(0), M)[0])
        state = dsgd.init_parallel_state(init, opt)
        r_step = jax.jit(ref_dsgd.make_parallel_step(r_loss, ref_opt))
        step = dsgd.make_parallel_step(loss, opt)
    else:
        r_state = ref_dsgd.init_state(r_init, ref_opt, M,
                                      jax.random.PRNGKey(0))
        state = dsgd.init_state(init, opt, M)
        if kind == "step":
            r_step = jax.jit(ref_dsgd.make_dsgd_step(r_loss, ref_opt))
            step = dsgd.make_dsgd_step(loss, opt)
        else:
            r_step = jax.jit(ref_dsgd.make_dsgd_round(r_loss, ref_opt, H))
            step = dsgd.make_dsgd_round(loss, opt, H)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(1)
    ref_rows, rows = [], []
    for t in range(rounds):
        hs = [make_agent_batches(ds, parts, 32, rng) for _ in range(H)]
        xb, yb = (np.stack([h[i] for h in hs]) for i in (0, 1))
        if H == 1:
            xb, yb = xb[0], yb[0]
        key, k = jax.random.split(key)
        W = ref_sched.mixing_matrix(t)
        assert W.tobytes() == sched.mixing_matrix(t).tobytes()
        if kind == "parallel":
            r_state, r_mets = r_step(r_state, (jnp.asarray(xb),
                                               jnp.asarray(yb)), k)
            state, mets = step(state, (torch.as_tensor(xb),
                                       torch.as_tensor(yb)))
        else:
            r_state, r_mets = r_step(r_state, (jnp.asarray(xb),
                                               jnp.asarray(yb)),
                                     jnp.asarray(W, jnp.float32), k)
            state, mets = step(state, (torch.as_tensor(xb),
                                       torch.as_tensor(yb)), W)
        names = sorted(r_mets)
        assert names == sorted(mets)
        ref_rows.append([float(r_mets[n]) for n in names])
        rows.append([float(mets[n]) for n in names])
    return (np.asarray(rows), np.asarray(ref_rows), names, state["params"],
            r_state["params"])


@pytest.mark.parametrize("kind", ["step", "round", "parallel"])
def test_tree_driver_matches_reference(kind):
    rows, ref_rows, names, params, ref_params = _drive(kind)
    assert np.all(np.isfinite(rows))
    # atol 1e-7: after the final merge (the "round" case) Xi is the float32
    # rounding of identical rows' mean, ~4e-7 in both packages
    np.testing.assert_allclose(rows, ref_rows, rtol=1e-5, atol=1e-7,
                               err_msg=str(names))
    # the final parameters: SGD's at 1e-5; AdamW's (the "round" case) at a
    # tenth of its learning rate, since an element whose second moment is
    # near eps amplifies a 1-ulp gradient difference into a step of another
    # size (measured up to 4.6e-4 on 128 of 131072 elements when the
    # thread count changes the CPU's summation order)
    tol = 1e-3 if kind == "round" else 1e-5
    _close(params, ref_params, atol=tol, rtol=1e-5)
    if kind == "round":  # the final merge: every row identical
        assert float(consensus.consensus_distance(params)) < 1e-6


def test_init_state_same_init_rows_are_copies():
    """same_init=True gives real copies (an in-place update of one row
    leaves the others alone), and the rows equal the one init."""
    def init_params(gen):
        return {"a": torch.randn(3, 2, generator=gen),
                "b": {"c": torch.randn(4, generator=gen)}}

    opt = make_optimizer("sgd", 0.1)
    state = dsgd.init_state(init_params, opt, 3,
                            torch.Generator().manual_seed(2), same_init=True)
    one = init_params(torch.Generator().manual_seed(2))
    for x, y in zip(tree_flatten(state["params"])[0], tree_flatten(one)[0]):
        for k in range(3):
            assert torch.equal(x[k], y)
        x[0].add_(1.0)
        assert torch.equal(x[1], y)
    distinct = dsgd.init_state(init_params, opt, 3,
                               torch.Generator().manual_seed(2))
    a = distinct["params"]["a"]
    assert torch.equal(a[0], one["a"]) and not torch.equal(a[1], a[0])


def test_tree_wire_paths_run():
    """The tree drivers with a stochastic per-leaf codec (int8 from the
    round's generator) and the legacy bf16 cast: W == I rounds leave the
    parameters untouched, communicating rounds keep Xi finite."""
    ds, parts, _, (init, loss, _) = _mlp(2)
    for kw in ({"wire": "int8"}, {"wire_dtype": torch.bfloat16}):
        opt = make_optimizer("sgd", 0.0, weight_decay=0.0, momentum=0.0)
        state = dsgd.init_state(init, opt, M)
        step = dsgd.make_dsgd_step(loss, opt, **kw)
        xb, yb = make_agent_batches(ds, parts, 8, np.random.default_rng(0))
        batch = (torch.as_tensor(xb), torch.as_tensor(yb))
        before = {k: v.clone() for k, v in state["params"].items()}
        if "wire" in kw:
            with pytest.raises(ValueError, match="rng="):
                step(state, batch, topo.identity(M))
        state, mets = step(state, batch, topo.identity(M), 0)
        for k, v in state["params"].items():
            assert torch.equal(v, before[k])
        state, mets = step(state, batch, topo.fully_connected(M), 1)
        assert np.isfinite(float(mets["consensus"]))
        assert float(mets["consensus"]) < float(
            consensus.consensus_distance(before))
