"""End-to-end behaviour of the paper's system on the port, at CPU scale.

The first part mirrors ``tests/test_system.py`` on the port's harness
(``repro_torch.bench.common``) with the reference's thresholds: a single
final global merging improves accuracy under sparse gossip and non-IID data,
local-only training is not mergeable, the merged model beats the local ones
only with communication, the final merge collapses consensus, the adaptive
schedule runs, and a counterfactual evaluation leaves the state alone.

The second part, three figure families against ``benchmarks.figures``,
lives in ``tests/test_torch_system_figures.py``."""
import numpy as np
import torch

import _torch_threads  # noqa: F401
from repro_torch.bench import common
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
