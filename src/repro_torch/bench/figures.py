"""One benchmark per paper figure or table (CPU-scale reproductions;
counterpart of ``benchmarks/figures.py``, the same constants).

Each function takes ``device`` (None: the CUDA card) and returns
(us_per_call, derived), where derived is the figure's headline quantity.

  python -m repro_torch.bench.figures [filter] [--device cpu]

prints ``benchmarks/run.py``'s CSV (``name,us_per_call,derived``) for the
functions whose name contains ``filter``, on the card unless ``--device
cpu`` is given, and exits non-zero if any function fails. The reference's
kernel and panel microbenchmarks have no counterpart here.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.bench.common import (M, agent_batch, init_generator,
                                      make_problem, mean_agent_acc,
                                      run_schedule)
from repro_torch.core import dsgd, gossip, topology
from repro_torch.core.merge import gossip_merge_rounds
from repro_torch.core.schedule import make_schedule
from repro_torch.device import resolve_device
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_flatten, tree_unflatten


def fig1_single_global_merging(device=None):
    """Fig. 1a/1b: sparse gossip + ONE final global merging vs local-only.
    derived = merged-over-local accuracy gain under R=0.2 gossip."""
    t0 = time.perf_counter()
    const = run_schedule("constant", seed=0, device=device)
    local_only = run_schedule("local", seed=0, device=device)
    us = (time.perf_counter() - t0) * 1e6
    derived = {
        "gossip_local_acc": round(const["local"], 4),
        "gossip_merged_acc": round(const["merged"], 4),
        "merge_gain": round(const["merged"] - const["local"], 4),
        "localonly_merged_acc": round(local_only["merged"], 4),
    }
    return us, derived


def fig2ab_window_allocation(device=None):
    """Fig. 2a/2b: fully-connected communication inside ONE window of 1/5 of
    training; later windows should win on final accuracy.
    derived = final acc per window position + late-early gap."""
    t0 = time.perf_counter()
    rounds = 80
    win = rounds // 5
    finals = []
    for wpos in range(5):
        out = run_schedule("windowed", rounds=rounds, seed=0,
                           start=wpos * win, end=(wpos + 1) * win,
                           device=device)
        finals.append(round(out["merged"], 4))
    us = (time.perf_counter() - t0) * 1e6
    derived = {"final_acc_by_window": finals,
               "late_minus_early": round(finals[-1] - finals[0], 4)}
    return us, derived


def fig2c_counterfactual_mergeability(device=None):
    """Fig. 2c: counterfactual merged-model accuracy vs local accuracy over
    training, with and without communication.
    derived = mean merged-local gap (comm) vs (no-comm)."""
    t0 = time.perf_counter()
    comm = run_schedule("constant", seed=1, track=True, device=device)
    nocomm = run_schedule("local", seed=1, track=True, device=device)
    us = (time.perf_counter() - t0) * 1e6
    gap = np.mean(np.array(comm["curves"]["merged"])
                  - np.array(comm["curves"]["local"]))
    gap0 = np.mean(np.array(nocomm["curves"]["merged"])
                   - np.array(nocomm["curves"]["local"]))
    derived = {"mean_gap_comm": round(float(gap), 4),
               "mean_gap_nocomm": round(float(gap0), 4),
               "merged_curve_comm": comm["curves"]["merged"][-4:],
               "merged_curve_nocomm": nocomm["curves"]["merged"][-4:]}
    return us, derived


def _grad_sq_norm(loss_fn, p, batch):
    """||grad L(p)||^2 on ``batch`` (summed over leaves)."""
    leaves, skel = tree_flatten(p)
    ps = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = loss_fn(tree_unflatten(skel, ps), batch)
    return sum(torch.sum(torch.square(g))
               for g in torch.autograd.grad(loss, ps))


def table1_convergence_rates(device=None):
    """Table 1: DSGD's merged model matches parallel SGD's convergence.
    derived = mean ||grad L(theta_bar)||^2 over the last 20 rounds for
    parallel SGD vs DSGD(merged), same lr/batch — their ratio should be
    O(1) (ours) rather than diverging (classic bound's extra 1/p terms)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ds, parts, init_params, loss_fn, acc = make_problem(seed=2, device=dev)
    opt = make_optimizer("sgd", 0.05, weight_decay=0.0)
    rounds = 100
    # parallel SGD
    pstate = dsgd.init_parallel_state(init_params, opt, init_generator(0))
    pstep = dsgd.make_parallel_step(loss_fn, opt)
    # DSGD sparse gossip
    dstate = dsgd.init_state(init_params, opt, M, init_generator(0),
                             same_init=True)
    dstep = dsgd.make_dsgd_step(loss_fn, opt)
    sched = make_schedule("constant", M, rounds, prob=0.2, seed=0)
    rng_np = np.random.default_rng(2)
    gpar, gmerged = [], []
    xe, ye = agent_batch(ds, parts, 256, rng_np, dev)
    eval_batch = (xe.reshape(-1, xe.shape[-1]), ye.reshape(-1))
    for t in range(rounds):
        batch = agent_batch(ds, parts, 32, rng_np, dev)
        pstate, _ = pstep(pstate, batch)
        W = sched.mixing_matrix(t)
        dstate, _ = dstep(dstate, batch, W)
        if t >= rounds - 20:
            gpar.append(float(_grad_sq_norm(loss_fn, pstate["params"],
                                            eval_batch)))
            # per-round eval: the per-leaf mean, no panel copy
            gmerged.append(float(_grad_sq_norm(
                loss_fn, gossip.merged_model_tree(dstate["params"]),
                eval_batch)))
    us = (time.perf_counter() - t0) * 1e6
    derived = {"parallel_sgd_gradsq": round(float(np.mean(gpar)), 6),
               "dsgd_merged_gradsq": round(float(np.mean(gmerged)), 6),
               "ratio": round(float(np.mean(gmerged) / max(np.mean(gpar),
                                                           1e-12)), 3)}
    return us, derived


def consensus_bound_corollary_d2(device=None):
    """Corollary D.2: E[Xi^2] <= 24 (1-p) eta^2 (phi^2 + sigma^2) / p^2.
    derived = empirical Xi^2 vs the bound for the R=0.2 random topology."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ds, parts, init_params, loss_fn, acc = make_problem(seed=3, device=dev)
    eta = 0.05
    opt = make_optimizer("sgd", eta, weight_decay=0.0)
    state = dsgd.init_state(init_params, opt, M, init_generator(0),
                            same_init=True)
    step = dsgd.make_dsgd_step(loss_fn, opt)
    rng_np = np.random.default_rng(3)
    p_est = topology.expected_p(topology.make_sampler("random", M, 0.2), M,
                                400, np.random.default_rng(0))
    xis, phis = [], []
    for t in range(120):
        W = topology.random_matching(M, 0.2, rng_np)
        batch = agent_batch(ds, parts, 32, rng_np, dev)
        state, mets = step(state, batch, W)
        xis.append(float(mets["consensus"]) ** 2)
        gs, _ = dsgd.tree_grads(loss_fn, state["params"], batch)
        phis.append(float(np.mean([float(torch.sum(torch.square(x)))
                                   for x in tree_flatten(gs)[0]])))
    phi2 = float(np.mean(phis)) * 1.0
    sigma2 = phi2  # conservative: noise bounded by gradient scale here
    bound = 24 * (1 - p_est) * eta ** 2 * (phi2 + sigma2) / p_est ** 2
    emp = float(np.mean(xis[20:]))
    us = (time.perf_counter() - t0) * 1e6
    derived = {"p_estimate": round(p_est, 4), "empirical_xi2": round(emp, 5),
               "bound": round(bound, 5),
               "satisfied": bool(emp <= bound)}
    return us, derived


def appendix_c34_gossip_merge(device=None):
    """Appendix C.3.4: final merge approximated by k rounds of exponential
    gossip. derived = accuracy of 1-round vs log2(m)-round gossip merge vs
    exact global merge."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ds, parts, init_params, loss_fn, acc = make_problem(seed=4, device=dev)
    opt = make_optimizer("sgd", 0.1, weight_decay=0.0)
    state = dsgd.init_state(init_params, opt, M, init_generator(0))
    step = dsgd.make_dsgd_step(loss_fn, opt)
    sched = make_schedule("constant", M, 60, prob=0.2, seed=4)
    rng_np = np.random.default_rng(4)
    for t in range(60):
        W = sched.mixing_matrix(t)
        state, _ = step(state, agent_batch(ds, parts, 32, rng_np, dev), W)
    sampler = topology.make_sampler("exponential", M)
    accs = {}
    for k_rounds in (1, int(np.log2(M))):
        merged = gossip_merge_rounds(state["params"], sampler, k_rounds,
                                     np.random.default_rng(0))
        accs[f"gossip_{k_rounds}r"] = round(mean_agent_acc(acc, merged), 4)
    accs["exact_merge"] = round(float(acc(gossip.merged_model(
        state["params"]))), 4)
    accs["local"] = round(mean_agent_acc(acc, state["params"]), 4)
    us = (time.perf_counter() - t0) * 1e6
    return us, accs


def _final_merge_run(name, seed, rounds, device, step_kw=None,
                     sched_kw=None, with_monitor=False):
    """One run of the figures' shared protocol: the MLP of ``seed``, SGD
    lr 0.1, the ``name`` schedule; returns (state, acc, comm, sched)."""
    dev = resolve_device(device)
    ds, parts, init_params, loss_fn, acc = make_problem(seed=seed,
                                                        device=dev)
    opt = make_optimizer("sgd", 0.1, weight_decay=0.0)
    state = dsgd.init_state(init_params, opt, M, init_generator(0))
    step = dsgd.make_dsgd_step(loss_fn, opt, **(step_kw or {}))
    sched = make_schedule(name, M, rounds, prob=0.2, seed=seed,
                          **(sched_kw or {}))
    rng_np = np.random.default_rng(seed)
    monitor = {}
    comm = 0.0
    for t in range(rounds):
        W = sched.mixing_matrix(t, monitor)
        comm += sched.round_cost(W)
        state, mets = step(state, agent_batch(ds, parts, 32, rng_np, dev),
                           W)
        if with_monitor:
            monitor = {"grad_norm": float(mets["grad_norm"]),
                       "consensus": float(mets["consensus"])}
    return state, acc, comm, sched


def beyond_adaptive_schedule(device=None):
    """BEYOND-PAPER: the adaptive critical-consensus-edge controller the
    paper's §6 calls for (Prop. 3 operationalised). Compare, at the SAME
    final-merge protocol: constant R=0.2 gossip vs the adaptive controller
    (sparse gossip, fully-connected only when Xi_t > kappa*mu_t).
    derived = accuracy and communication budget of each."""
    t0 = time.perf_counter()
    out = {}
    for name, kw in (("constant", {}), ("adaptive", {"kappa": 8.0})):
        state, acc, comm, sched = _final_merge_run(
            name, 5, 80, device, sched_kw=kw, with_monitor=True)
        merged = float(acc(gossip.merged_model(state["params"])))
        out[name] = {"merged_acc": round(merged, 4),
                     "comm_P": round(comm, 1)}
        if name == "adaptive":
            out[name]["global_rounds"] = getattr(sched, "global_rounds",
                                                 [])[:8]
    us = (time.perf_counter() - t0) * 1e6
    return us, out


def beyond_bf16_gossip(device=None):
    """BEYOND-PAPER: CocktailSGD-flavoured wire compression — run the same
    final-merge protocol with bf16 gossip payloads and verify accuracy
    parity (the bf16 wire lever is quality-safe)."""
    t0 = time.perf_counter()
    out = {}
    for name, wire in (("f32", None), ("bf16", torch.bfloat16)):
        state, acc, _, _ = _final_merge_run(
            "final_merge", 6, 80, device, step_kw={"wire_dtype": wire})
        out[name] = round(float(acc(gossip.merged_model(state["params"]))),
                          4)
    out["parity_gap"] = round(out["bf16"] - out["f32"], 4)
    us = (time.perf_counter() - t0) * 1e6
    return us, out


BENCHES = [
    ("fig1_single_global_merging", fig1_single_global_merging),
    ("fig2ab_window_allocation", fig2ab_window_allocation),
    ("fig2c_counterfactual_mergeability", fig2c_counterfactual_mergeability),
    ("table1_convergence_rates", table1_convergence_rates),
    ("corollary_d2_consensus_bound", consensus_bound_corollary_d2),
    ("appendix_c34_gossip_merge", appendix_c34_gossip_merge),
    ("beyond_adaptive_schedule", beyond_adaptive_schedule),
    ("beyond_bf16_gossip", beyond_bf16_gossip),
]


def csv_line(name, us, derived) -> str:
    return f"{name},{us:.0f},\"{json.dumps(derived)}\""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The paper's figures on the port (CSV to stdout).")
    ap.add_argument("filter", nargs="?", default=None,
                    help="run the benchmarks whose name contains this")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("name,us_per_call,derived")
    failures = 0
    for name, fn in BENCHES:
        if args.filter and args.filter not in name:
            continue
        try:
            us, derived = fn(device=device)
            print(csv_line(name, us, derived), flush=True)
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"{name},-1,\"ERROR: {type(e).__name__}: {e}\"",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
