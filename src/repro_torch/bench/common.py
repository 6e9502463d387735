"""Shared harness of the paper-figure benchmarks (counterpart of
``benchmarks/common.py``): CPU-scale instances of the paper's experiments —
m agents, Dirichlet alpha = 0.1, sparse random gossip R = 0.2, the
schedules of ``core.schedule`` — on the tree-state driver.

Every function runs on the CUDA card unless its caller passes
``device="cpu"``. The MLP's initial parameters are drawn by a CPU
``torch.Generator`` from the seed and then moved to the device, so a CPU run
and a card run start from the same parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dsgd, gossip
from repro_torch.core.schedule import make_schedule
from repro_torch.data.synthetic import (SyntheticClassification,
                                        make_agent_batches)
from repro_torch.device import resolve_device
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_flatten, tree_unflatten

M = 8
ROUNDS = 80
ALPHA = 0.1


def init_generator(seed: int) -> torch.Generator:
    """The CPU generator the MLP's initial parameters are drawn from."""
    return torch.Generator().manual_seed(seed)


def make_problem(seed=0, dim=32, classes=10, depth=2, width=128,
                 device=None):
    """Depth-2 ReLU MLP on Dirichlet(0.1)-partitioned gaussian blobs.

    A genuinely non-convex instance: with ZERO communication, averaging
    independently initialised local models lands below chance (permutation
    misalignment), while limited gossip keeps models mergeable — the
    paper's core phenomenon at CPU scale. Returns (ds, parts, init_params,
    loss_fn, acc): ``init_params(gen)`` draws one model from the CPU
    generator ``gen`` onto the device; ``acc(p)`` is the test accuracy (a
    0-d tensor)."""
    dev = resolve_device(device)
    ds = SyntheticClassification(num_classes=classes, dim=dim, n_train=4096,
                                 n_test=1024, seed=seed)
    parts = ds.partition(M, alpha=ALPHA, seed=seed + 1)
    dims = [dim] + [width] * depth + [classes]
    x_test = torch.as_tensor(ds.x_test, device=dev)
    y_test = torch.as_tensor(ds.y_test, device=dev).long()

    def init_params(gen):
        p = {}
        for i in range(depth + 1):
            w = (torch.randn((dims[i], dims[i + 1]), generator=gen)
                 / np.sqrt(dims[i]))
            p[f"w{i}"] = w.to(dev)
            p[f"b{i}"] = torch.zeros(dims[i + 1], device=dev)
        return p

    def fwd(p, x):
        h = x
        for i in range(depth):
            h = torch.relu(h @ p[f"w{i}"] + p[f"b{i}"])
        return h @ p[f"w{depth}"] + p[f"b{depth}"]

    def loss_fn(p, batch, rng=None):
        x, y = batch
        lg = fwd(p, x)
        nll = torch.mean(torch.logsumexp(lg, -1) - torch.take_along_dim(
            lg, y[:, None].long(), -1)[:, 0])
        return nll, {}

    @torch.no_grad()
    def acc(p):
        lg = fwd(p, x_test)
        return torch.mean((torch.argmax(lg, -1) == y_test).to(torch.float32))

    return ds, parts, init_params, loss_fn, acc


def agent_tree(params, k):
    """Agent k's tree out of an agent-stacked tree (views)."""
    leaves, skel = tree_flatten(params)
    return tree_unflatten(skel, [x[k] for x in leaves])


def mean_agent_acc(acc, params) -> float:
    """Mean over agents of each agent's own accuracy."""
    m = tree_flatten(params)[0][0].shape[0]
    return float(torch.mean(torch.stack([acc(agent_tree(params, k))
                                         for k in range(m)])))


def agent_batch(ds, parts, batch, rng_np, device):
    """One (m, batch, ...) step of per-agent batches on the device."""
    xb, yb = make_agent_batches(ds, parts, batch, rng_np)
    return (torch.as_tensor(xb, device=device),
            torch.as_tensor(yb, device=device))


def run_schedule(schedule_name, rounds=ROUNDS, seed=0, track=False,
                 batch=32, lr=0.1, device=None, **kw):
    """Returns a dict with local/merged accuracy (+ curves if track)."""
    dev = resolve_device(device)
    ds, parts, init_params, loss_fn, acc = make_problem(seed, device=dev)
    opt = make_optimizer("sgd", lr, weight_decay=0.0)
    state = dsgd.init_state(init_params, opt, M, init_generator(seed))
    step = dsgd.make_dsgd_step(loss_fn, opt)
    sched = make_schedule(schedule_name, M, rounds, prob=0.2, seed=seed,
                          **kw)
    rng_np = np.random.default_rng(seed)
    monitor = {}
    curves = {"local": [], "merged": [], "xi": []}
    comm = 0.0
    for t in range(rounds):
        W = sched.mixing_matrix(t, monitor)
        comm += sched.round_cost(W)
        state, mets = step(state, agent_batch(ds, parts, batch, rng_np, dev),
                           W)
        monitor = {"grad_norm": float(mets["grad_norm"]),
                   "consensus": float(mets["consensus"])}
        if track and (t % 5 == 0 or t == rounds - 1):
            curves["local"].append(mean_agent_acc(acc, state["params"]))
            # per-round tracking: the per-leaf mean, no panel copy
            curves["merged"].append(float(acc(gossip.merged_model_tree(
                state["params"]))))
            curves["xi"].append(monitor["consensus"])
    local = mean_agent_acc(acc, state["params"])
    merged = float(acc(gossip.merged_model(state["params"])))
    out = {"local": local, "merged": merged, "comm_P": comm}
    if track:
        out["curves"] = curves
    return out
