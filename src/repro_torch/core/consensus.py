"""Consensus-distance and mergeability diagnostics (paper §5 quantities;
counterpart of ``repro/core/consensus.py``).

* Xi_t        — consensus distance sqrt( (1/m) sum_k ||theta_k - bar||^2 )
                (= sqrt Tr Gamma^(t)).
* u_term      — the progressive-sharpening term
                grad L(bar)^T grad Tr( H(bar) Gamma ) (Theorem 1's U^(t)
                leading part) by nested forward-mode derivatives over
                reverse mode (``torch.func``); negative under Assumption 4.
* mergeability_gap — counterfactual merged-model metric minus mean local
                metric (Def. 2 operationalised).
"""
from __future__ import annotations

import torch
from torch.func import grad, jvp

from repro_torch.core import panel as panel_mod
from repro_torch.core.gossip import merged_model
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def consensus_distance(params_stacked) -> torch.Tensor:
    """Xi_t over an agent-stacked tree (leaves (m, ...)), backed by the
    panel engine: one ``panel_mean_consensus`` pass per dtype group."""
    spec = panel_mod.make_spec(params_stacked)
    return panel_mod.consensus_distance(
        panel_mod.to_panel(params_stacked, spec))


def consensus_distance_tree(params_stacked) -> torch.Tensor:
    """Per-leaf Xi_t: a float32 mean per leaf, then the squared deviations
    summed a row at a time (no (m, ...) temporary of a whole leaf)."""
    leaves = tree_flatten(params_stacked)[0]
    m = leaves[0].shape[0]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        mean = torch.mean(x.to(torch.float32), dim=0)
        for r in range(m):
            total = total + torch.sum(torch.square(
                x[r].to(torch.float32) - mean))
        del mean
    return torch.sqrt(total / m)


def gamma_trace(params_stacked) -> torch.Tensor:
    return torch.square(consensus_distance(params_stacked))


def _tree_dot(a, b):
    return sum(torch.sum(x.to(torch.float32) * y.to(torch.float32))
               for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def u_term(loss_fn, params_stacked, batch) -> torch.Tensor:
    """Estimate grad L(bar)^T grad Tr( H(bar) Gamma^(t) ).

    Tr(H Gamma) = (1/m) sum_k d_k^T H d_k with d_k = theta_k - bar, each
    d_k^T H d_k a Hessian-vector product (``jvp`` of ``grad``); its
    directional derivative along grad L takes one more ``jvp``. Cubic
    nesting: for CPU-scale models (benchmarks) only. ``loss_fn(p, batch)``
    returns the loss or a (loss, aux) tuple."""
    bar = merged_model(params_stacked)
    leaves, skel = tree_flatten(params_stacked)
    m = leaves[0].shape[0]
    deltas = tree_unflatten(skel, [
        (x.to(torch.float32) - b[None]).detach()
        for x, b in zip(leaves, tree_flatten(bar)[0])])

    def scalar_loss(p):
        out = loss_fn(p, batch)
        return out[0] if isinstance(out, tuple) else out

    grad_fn = grad(scalar_loss)

    def sharpness(p):
        # (1/m) sum_k d_k^T H(p) d_k, each through a jvp of grad
        def one(k):
            d_k = tree_map(lambda d: d[k], deltas)
            _, hvp = jvp(grad_fn, (p,), (d_k,))
            return _tree_dot(hvp, d_k)
        return sum(one(k) for k in range(m)) / m

    g = grad_fn(bar)
    _, dir_deriv = jvp(sharpness, (bar,), (g,))
    return dir_deriv


def mergeability_gap(eval_fn, params_stacked):
    """(metric(merged), mean_k metric(theta_k), gap). ``eval_fn`` maps a
    single (non-stacked) parameter tree to a scalar metric (e.g.
    accuracy)."""
    merged_metric = eval_fn(merged_model(params_stacked))
    leaves, skel = tree_flatten(params_stacked)
    local = torch.stack([
        torch.as_tensor(eval_fn(tree_unflatten(skel, [x[k] for x in leaves])))
        for k in range(leaves[0].shape[0])])
    mean_local = torch.mean(local)
    return merged_metric, mean_local, merged_metric - mean_local
