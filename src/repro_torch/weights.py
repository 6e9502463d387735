"""Hand the JAX package's parameters over to the port.

``jax.random`` draws cannot be reproduced in PyTorch, so a comparison of
the two packages starts from the same numbers: the reference's parameter
tree, turned into numpy arrays, becomes the port's tree and panel here.
Leaves keep the reference's shapes (the stacked layer axis included) and
go into the panel in ``jax.tree_util`` flatten order (sorted dict keys), so a
reference panel loads bit for bit. The merge operators' statistics panels
(the reference's ``state["merge_stat"]``) hand over the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import panel as panel_mod
from repro_torch.device import resolve_device
from repro_torch.utils.tree import tree_map


def from_reference_params(tree, device=None):
    """Agent-stacked reference tree of numpy arrays (every leaf (m, ...)) ->
    (params, panel, spec): the port's tree of tensors on ``device``, its
    {dtype: (m, D)} panel and the panel's spec."""
    device = resolve_device(device)
    params = tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)
    spec = panel_mod.make_spec(params)
    return params, panel_mod.to_panel(params, spec), spec


def merge_stat_from_reference(stats, spec, device=None):
    """The reference's merge statistics {stat: {group: (m, D_g) array}} ->
    the same panels as float32 tensors on ``device``, each group checked
    against ``spec`` (its dtype groups, their widths D_g and, when the spec
    has them, its m rows)."""
    device = resolve_device(device)
    widths = dict(spec.groups)
    out = {}
    for name, groups in stats.items():
        if set(groups) != set(widths):
            raise ValueError(f"merge stat {name!r} has groups "
                             f"{sorted(groups)}, the spec {sorted(widths)}")
        out[name] = {}
        for g, x in groups.items():
            a = np.array(x, dtype=np.float32, copy=True)
            if a.ndim != 2 or a.shape[1] != widths[g] or (
                    spec.rows and a.shape[0] != spec.rows):
                raise ValueError(
                    f"merge stat {name!r} group {g!r} is {a.shape}; the "
                    f"spec has {spec.rows or 'm'} rows of width {widths[g]}")
            out[name][g] = torch.from_numpy(a).to(device)
    return out
