"""Global merging and counterfactual evaluation, main-path subset
(counterpart of ``repro/core/merge.py``)."""
from __future__ import annotations

from repro_torch import merging as merging_mod
from repro_torch.core import panel as panel_mod


def merged_panel_tree(panel, spec):
    """Merged (non-stacked, f32-leaf) model of an engine panel under the
    spec's merge operator."""
    row = merging_mod.get_merger(spec.merger).merge_row(panel)
    return panel_mod.from_panel(row, spec, cast=False)


def counterfactual_eval_panel(eval_fn, panel, spec):
    """Evaluate the hypothetical merged model without modifying the panel
    (Fig. 2c's merged-model curve)."""
    return eval_fn(merged_panel_tree(panel, spec))
