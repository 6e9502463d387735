"""Global merging operators and counterfactual evaluation (paper §4.2-4.3;
counterpart of ``repro/core/merge.py``).

Tree-level entry points over the merge operators of
``repro_torch.merging``: :func:`merge_stacked` merges an agent-stacked
tree under any registered operator (the oracle the engine's global rounds
are tested against), :func:`counterfactual_eval` evaluates the
hypothetical merged model without touching training state (Fig. 2c's
merged-model curve), and their panel counterparts
:func:`merged_panel_tree` / :func:`counterfactual_eval_panel` work on the
engine's panel state. The scanned gossip approximation of the final merge
(``gossip_merge_rounds``, Appendix C.3.4) comes in a later slice.
"""
from __future__ import annotations

import torch

from repro_torch import merging as merging_mod
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
