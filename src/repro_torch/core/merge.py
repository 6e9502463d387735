"""Global merging operators and counterfactual evaluation (paper §4.2-4.3;
counterpart of ``repro/core/merge.py``).

Tree-level entry points over the merge operators of
``repro_torch.merging``: :func:`merge_stacked` merges an agent-stacked
tree under any registered operator (the oracle the engine's global rounds
are tested against), :func:`counterfactual_eval` evaluates the
hypothetical merged model without touching training state (Fig. 2c's
merged-model curve), and their panel counterparts
:func:`merged_panel_tree` / :func:`counterfactual_eval_panel` work on the
engine's panel state, and :func:`gossip_merge_rounds` approximates the final
merge by rounds of gossip (Appendix C.3.4).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import merging as merging_mod
from repro_torch import wire as wire_mod
from repro_torch.core import panel as panel_mod
from repro_torch.utils.tree import tree_flatten, tree_map


def weighted_merge(params_stacked, weights):
    """sum_k w_k theta_k with convex weights (Def. 2's general merge)."""
    leaf = tree_flatten(params_stacked)[0][0]
    w = torch.as_tensor(weights, dtype=torch.float32, device=leaf.device)
    w = w / torch.sum(w)
    return tree_map(lambda x: torch.tensordot(w, x.to(torch.float32),
                                              dims=1), params_stacked)


def uniform_merge(params_stacked):
    """The globally averaged model: the agent axis dropped, float32
    leaves."""
    return merge_stacked(params_stacked)


def merge_stacked(params_stacked, merger="uniform", stats=None,
                  weights=None, live=None):
    """The merged (non-stacked, float32-leaf) model of an agent-stacked tree
    under a named merge operator. ``stats`` are the operator's statistics
    PANELS ({stat_name: {dtype-group: (m, D_g) f32}}, e.g.
    ``state["merge_stat"]``); ``weights`` the (m,) agent weights of the
    'weighted' operator; ``live`` ((m,) bool) merges the live agents only
    (an elastic run's merge leaves dead agents' stale rows out)."""
    spec = panel_mod.make_spec(params_stacked)
    return merged_panel_tree(panel_mod.to_panel(params_stacked, spec),
                             spec, merger=merger, stats=stats,
                             weights=weights, live=live)


def counterfactual_eval(eval_fn, params_stacked, merger="uniform",
                        stats=None, weights=None, live=None):
    """Evaluate the hypothetical globally merged model of an agent-stacked
    tree WITHOUT modifying it, under any merge operator (``live``: the
    live agents only)."""
    return eval_fn(merge_stacked(params_stacked, merger=merger,
                                 stats=stats, weights=weights, live=live))


def merged_panel_tree(panel, spec, merger=None, stats=None, weights=None,
                      live=None):
    """Merged (non-stacked, float32-leaf) model of an engine panel under the
    spec's (or an explicit) merge operator; ``stats`` may be held in the
    spec's residency storage (``merging.decode_stats``); ``live`` ((m,)
    bool) merges the live rows only."""
    mg = merging_mod.get_merger(spec.merger if merger is None else merger)
    stats = merging_mod.decode_stats(stats, spec)
    row = mg.merge_row(panel, stats=stats, weights=weights, live=live)
    return panel_mod.from_panel(row, spec, cast=False)


def counterfactual_eval_panel(eval_fn, panel, spec, merger=None, stats=None,
                              weights=None, live=None):
    """Evaluate the hypothetical merged model of the engine's panel state
    (``stats`` = ``state["merge_stat"]``) without modifying the panel
    (Fig. 2c's merged-model curve); ``live`` as in
    :func:`merged_panel_tree`."""
    return eval_fn(merged_panel_tree(panel, spec, merger=merger,
                                     stats=stats, weights=weights,
                                     live=live))


def gossip_merge_rounds(params_stacked, sampler, rounds: int, rng,
                        wire=None, gen=None, return_xi: bool = False):
    """Approximate the final global merging by ``rounds`` rounds of gossip
    on a (e.g. exponential) topology: paper Appendix C.3.4.

    Panelises once, samples every W^(t) = ``sampler(t, rng)`` up front with
    numpy, and runs the folded-mean mix (``panel.mix_dense_mean``, the
    engine's round primitive: the ``gossip_mix`` kernel on the card, one
    launch a round and dtype group) for each round. ``wire`` names a codec
    of ``repro_torch.wire`` for the payload (a stochastic one draws from
    ``gen``); error-feedback codecs are refused, since this stateless path
    carries no residual. ``return_xi=True`` also returns the (rounds,)
    consensus-distance trace read off the folded mean
    (``panel.consensus_from_mean``): how fast the approximation converges
    to the true merge."""
    spec = panel_mod.make_spec(params_stacked)
    if wire is not None:
        if wire_mod.get_codec(wire).error_feedback:
            raise ValueError(
                f"codec '{wire}' needs an error-feedback residual, which "
                "this stateless approximation path cannot carry; use the "
                "panel engine (dsgd.make_panel_segment) or 'int8'")
        spec = panel_mod.with_wire(spec, wire)
    Ws = [np.asarray(sampler(t, rng), np.float32) for t in range(rounds)]
    pan = panel_mod.to_panel(params_stacked, spec)
    xis = []
    for W in Ws:
        pan, mean, _ = panel_mod.mix_dense_mean(pan, W, spec=spec, gen=gen)
        xis.append(panel_mod.consensus_from_mean(pan, mean))
        del mean
    out = panel_mod.from_panel(pan, spec)
    if not return_xi:
        return out
    return out, (torch.stack(xis) if xis else torch.zeros(
        0, device=next(iter(pan.values())).device))
