"""End-to-end behaviour of the paper's system on the port, at CPU scale.

The first part mirrors ``tests/test_system.py`` on the port's harness
(``repro_torch.bench.common``) with the reference's thresholds: a single
final global merging improves accuracy under sparse gossip and non-IID data,
local-only training is not mergeable, the merged model beats the local ones
only with communication, the final merge collapses consensus, the adaptive
schedule runs, and a counterfactual evaluation leaves the state alone.

The second part holds three figure families, port against
``benchmarks.figures`` on the CPU, the port's initial parameters handed over
from the reference (``make_problem``'s init replaced by the reference's rows):
accuracies within 0.01 and Table 1's ratio within 2 % (80-100 rounds of
float32 SGD in two packages: the rounding of sums in other orders drifts)."""
import itertools

import jax
import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
import benchmarks.figures as ref_figures
from repro_torch.bench import common, figures
from repro_torch.core import consensus, dsgd, gossip
from repro_torch.core.merge import counterfactual_eval
from repro_torch.core.schedule import make_schedule
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_flatten

M = 8


def run(schedule_name, rounds=80, seed=0, **kw):
    ds, parts, init_params, loss_fn, acc = common.make_problem(
        seed, device="cpu")
    opt = make_optimizer("sgd", 0.1, weight_decay=0.0)
    state = dsgd.init_state(init_params, opt, M, common.init_generator(seed))
    step = dsgd.make_dsgd_step(loss_fn, opt)
    sched = make_schedule(schedule_name, M, rounds, prob=0.2, seed=seed, **kw)
    rng_np = np.random.default_rng(seed)
    monitor = {}
    for t in range(rounds):
        W = sched.mixing_matrix(t, monitor)
        state, mets = step(state, common.agent_batch(ds, parts, 32, rng_np,
                                                     "cpu"), W)
        monitor = {"grad_norm": float(mets["grad_norm"]),
                   "consensus": float(mets["consensus"])}
    local = common.mean_agent_acc(acc, state["params"])
    merged = float(acc(gossip.merged_model(state["params"])))
    return state, local, merged, acc


def test_final_merge_recovers_performance():
    """Paper Fig. 1: single global merging >> local models under sparse
    gossip + alpha = 0.1 heterogeneity."""
    state, local, merged, acc = run("constant")
    assert merged > local + 0.05, (local, merged)
    assert merged > 0.30


def test_local_only_not_mergeable():
    """Paper Fig. 2c orange: no communication => merging does NOT help."""
    _, local, merged, _ = run("local")
    assert merged < 0.25, merged


def test_mergeability_requires_nonzero_communication():
    _, local_c, merged_c, _ = run("constant", rounds=60)
    _, local_l, merged_l, _ = run("local", rounds=60)
    assert merged_c - local_c > merged_l - local_l + 0.03


def test_final_merge_schedule_collapses_consensus():
    state, local, merged, _ = run("final_merge", rounds=40)
    xi = float(consensus.consensus_distance(state["params"]))
    assert xi < 1e-3
    assert abs(local - merged) < 1e-5


def test_adaptive_schedule_runs_and_communicates_late():
    state, local, merged, _ = run("adaptive", rounds=60, kappa=2.0)
    assert merged > 0.25


def test_counterfactual_eval_does_not_modify_state():
    ds, parts, init_params, loss_fn, acc = common.make_problem(device="cpu")
    opt = make_optimizer("sgd", 0.1)
    state = dsgd.init_state(init_params, opt, M, common.init_generator(0))
    before = [x.clone() for x in tree_flatten(state["params"])[0]]
    _ = counterfactual_eval(acc, state["params"])
    assert all(torch.equal(a, b) for a, b in zip(
        before, tree_flatten(state["params"])[0]))


# ------------------------------------------- figures against the reference


def _hand_over(monkeypatch, key_rows):
    """Replace the port's make_problem init by the reference's rows:
    ``key_rows`` gives the JAX keys whose inits the port's init_params
    returns in turn (cycling), whatever generator it is handed."""
    real = common.make_problem

    def handed(seed=0, device=None, **kw):
        ds, parts, _, loss_fn, acc = real(seed, device=device, **kw)
        r_init = ref_common.make_problem(seed)[2]
        rows = [{k: torch.as_tensor(np.array(v)) for k, v in
                 r_init(key).items()} for key in key_rows]
        it = itertools.cycle(rows)
        return ds, parts, (lambda gen: next(it)), loss_fn, acc

    monkeypatch.setattr(common, "make_problem", handed)
    monkeypatch.setattr(figures, "make_problem", handed)


def _split(seed):
    return list(jax.random.split(jax.random.PRNGKey(seed), M))


def _accs_close(got, ref, keys):
    for k in keys:
        assert abs(got[k] - ref[k]) <= 0.01, (k, got, ref)


def test_fig1_matches_reference(monkeypatch):
    _hand_over(monkeypatch, _split(0))
    _, ref = ref_figures.fig1_single_global_merging()
    _, got = figures.fig1_single_global_merging(device="cpu")
    _accs_close(got, ref, ("gossip_local_acc", "gossip_merged_acc",
                           "localonly_merged_acc"))


def test_appendix_c34_matches_reference(monkeypatch):
    _hand_over(monkeypatch, _split(0))
    _, ref = ref_figures.appendix_c34_gossip_merge()
    _, got = figures.appendix_c34_gossip_merge(device="cpu")
    _accs_close(got, ref, ("gossip_1r", "gossip_3r", "exact_merge", "local"))
    assert abs(got["gossip_3r"] - got["exact_merge"]) <= 0.01


def test_table1_matches_reference(monkeypatch):
    _hand_over(monkeypatch, [jax.random.PRNGKey(0)])
    _, ref = ref_figures.table1_convergence_rates()
    _, got = figures.table1_convergence_rates(device="cpu")
    assert np.isfinite(got["ratio"])
    assert got["ratio"] == pytest.approx(ref["ratio"], rel=0.02), (got, ref)
