"""Logical sharding specs resolved onto a mesh: the shape logic of
``repro/models/sharding.py``.

A spec leaf is a tuple of *logical* axis names (or ``None``, or tuples of
names) aligned to the TRAILING dims of an array; :func:`resolve_leaf`
substitutes mesh axes for them by a rule table (``TRAIN_RULES``: fsdp ->
'fsdp', model and expert -> 'model', data -> ('pod', 'agent');
``serve_rules``: fsdp -> None (small) or the data axes (big), model and
expert -> 'model', data -> the data axes), dropping a name whose mesh axes
are absent, of size 1, or do not divide the dim (the dim is then
replicated). The models' trees of logical names are their ``param_spec()``
and ``cache_spec()``. :func:`panel_pspec` gives the flat panel's layout:
rows over ``PANEL_ROW_AXES`` ('pod', 'agent'), columns over
``PANEL_COL_AXES`` ('fsdp'), each claimed only when it divides; the
'model' axis replicates the panel. By default every 'model' rank computes
its agents' whole local step; on the ``param_shardings`` route (the
resolved ``TRAIN_RULES`` tree handed to ``core.dsgd.make_panel_segment``,
``models/tensor_parallel.py``) the 'model' ranks split it by heads, d_ff
columns and vocabulary, and the 'fsdp' ranks by batch rows.

PyTorch has no PartitionSpec: specs are plain tuples, one entry a dim (an
axis name, a tuple of names or None), equal to the reference's
``tuple(PartitionSpec(...))``. A mesh is anything with a ``shape``
{axis: size} mapping (``launch.mesh.Mesh``, or a stand-in in tests).

The reference's ``constrain``, ``constrain_pick`` and
``activation_sharding`` are hints to XLA's SPMD partitioner about
activations inside one agent's step; they have no counterpart here: the
split route places its activations explicitly.
"""
from __future__ import annotations

import numpy as np

TRAIN_RULES = {"fsdp": "fsdp", "model": "model", "expert": "model",
               "data": ("pod", "agent")}

# the flat-panel engine's layout on the training mesh: panel rows (one per
# agent) on the ('pod', 'agent') axes, the flattened parameter columns
# fsdp-sharded; 'model' replicates the panel
PANEL_ROW_AXES = ("pod", "agent")
PANEL_COL_AXES = ("fsdp",)


def _axis_names(mesh):
    return tuple(getattr(mesh, "axis_names", None) or tuple(mesh.shape))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return mesh.shape[axis]


def resolve_leaf(spec_leaf, shape, mesh, rules, prefix=()):
    """Resolve one logical spec against an array shape and a mesh.

    Logical names align to the TRAILING dims of the leaf (stacked leading
    dims, the agent axis or a layer stack, are skipped); the ``prefix``
    mesh axes claim the leading dims. Returns a tuple, one entry a dim."""
    axes = list(prefix) + [None] * (len(shape) - len(prefix))
    names = tuple(spec_leaf)[-max(0, len(shape) - len(prefix)):]
    offset = len(shape) - len(names)
    for i, name in enumerate(names):
        dim = offset + i
        if name is None:
            continue
        target = rules.get(name, None)
        if target is None:
            continue
        size = _axis_size(mesh, target)
        if size > 1 and shape[dim] % size == 0 and axes[dim] is None:
            axes[dim] = target
    return tuple(axes)


def _is_spec_leaf(s) -> bool:
    return isinstance(s, tuple) and all(
        isinstance(e, (str, tuple, type(None))) for e in s)


def resolve(spec_tree, shape_tree, mesh, rules, prefix=()):
    """Resolve a logical spec tree (nested dicts of spec leaves) against a
    tree of the same structure whose leaves have a ``shape`` (tensors, or
    anything with ``.shape``); returns the tree of resolved tuples."""
    if _is_spec_leaf(spec_tree):
        return resolve_leaf(spec_tree, tuple(shape_tree.shape), mesh, rules,
                            prefix)
    if isinstance(spec_tree, dict):
        return {k: resolve(v, shape_tree[k], mesh, rules, prefix)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(resolve(v, x, mesh, rules, prefix)
                               for v, x in zip(spec_tree, shape_tree))
    raise TypeError(f"not a spec tree node: {spec_tree!r}")


def panel_pspec(mesh, rows: int, width: int, row_axes=PANEL_ROW_AXES,
                col_axes=PANEL_COL_AXES):
    """(row entry, column entry) of one (rows, width) panel group on
    ``mesh``: an axis set is claimed only when present on the mesh AND the
    dim divides by its total size; the dim is replicated otherwise (e.g. an
    odd-width bf16 dtype group on a 2-way fsdp axis)."""
    names = _axis_names(mesh)

    def claim(dim, axes):
        axes = tuple(a for a in axes if a in names)
        if not axes:
            return None
        size = _axis_size(mesh, axes)
        if size <= 1 or dim % size:
            return None
        return axes if len(axes) > 1 else axes[0]

    return (claim(rows, row_axes), claim(width, col_axes))


SERVE_RULES_SMALL = {"fsdp": None, "model": "model", "expert": "model",
                     "data": "data"}


def serve_rules(mesh, big: bool):
    """The serve meshes' rules ((16, 16) over ('data', 'model'), or with a
    'pod' axis first): weights and KV caches over 'model', the batch over
    the data axes, and (``big``) the weights' fsdp dim over them too. On
    the port's serve mesh (``launch.mesh.serve_shape``: no 'data' axis,
    the production mesh's pod and data axes flattened onto 'fsdp') the
    data axes are 'fsdp'."""
    names = _axis_names(mesh)
    if "data" not in names:
        data_axes = ("fsdp",)
    else:
        data_axes = ("pod", "data") if "pod" in names else ("data",)
    da = data_axes if len(data_axes) > 1 else data_axes[0]
    rules = {"model": "model", "expert": "model", "data": da}
    rules["fsdp"] = da if big else None
    return rules
