"""Hand the JAX package's parameters over to the port.

``jax.random`` draws cannot be reproduced in PyTorch, so a comparison of
the two packages starts from the same numbers: the reference's parameter
tree, turned into numpy arrays, becomes the port's tree and panel here.
Leaves keep the reference's shapes (the stacked layer axis included) and
go into the panel in ``jax.tree_util`` flatten order (sorted dict keys), so a
reference panel loads bit for bit. The merge operators' statistics panels
(the reference's ``state["merge_stat"]``) and the residency storages'
stored panels (int8 ``{"q", "scale"}`` dicts, bf16 arrays) hand over the
same way.
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
    {dtype: (m, D)} panel and the panel's spec. bfloat16 leaves (numpy's
    ml_dtypes bfloat16) move as their bits."""
    device = resolve_device(device)
    params = tree_map(lambda x: _tensor(x, device), tree)
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


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: move its bits
        bits = np.array(a.view(np.uint16), copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def stored_from_reference(stored, device=None):
    """One of the reference's stored panels (a residency storage's form:
    ``{"q": int8, "scale": float32}`` for the int8 storages, a bf16 array
    for bf16, a float32 array for the identity) -> the port's stored form
    on ``device``, bit for bit."""
    device = resolve_device(device)
    if isinstance(stored, dict):
        if set(stored) != {"q", "scale"}:
            raise ValueError(f"a stored int8 panel has keys q and scale, "
                             f"got {sorted(stored)}")
        q, scale = _tensor(stored["q"], device), _tensor(stored["scale"],
                                                         device)
        if q.dtype != torch.int8 or scale.dtype != torch.float32 \
                or q.dim() != 2 or scale.dim() != 2 \
                or scale.shape[0] != q.shape[0]:
            raise ValueError(f"stored int8 panel: q {q.dtype} "
                             f"{tuple(q.shape)}, scale {scale.dtype} "
                             f"{tuple(scale.shape)}")
        return {"q": q, "scale": scale}
    return _tensor(stored, device)
