"""Flat-panel parameter engine, main-path subset (counterpart of
``repro/core/panel.py``).

An agent-stacked parameter tree (every leaf (m, ...)) is flattened into a
*panel* ``{dtype_name: (m, D_dtype)}``, one row per agent and one column per
scalar parameter, described by a :class:`PanelSpec`. Leaves are laid out in
sorted-key order (``utils/tree.py``), as ``jax.tree_util`` flattens the
reference's trees, so a panel of the JAX package loads here column for
column.

The communication ops run one fused op per dtype group:

* :func:`mix_dense` / :func:`mix_dense_mean` — Theta <- W Theta through the
  ``gossip_mix`` kernel; ``mix_dense_mean`` appends a 1^T/m row to W so the
  column mean comes out of the same sweep.
* :func:`merged` / :func:`consensus_distance` — the column mean and the
  consensus distance Xi through the ``panel_mean_consensus`` kernel.

On CUDA tensors the kernel wrappers launch the Hopper kernels; on CPU
tensors they run the plain versions. This slice carries the float32 wire
only (no codecs, no error feedback) and unsharded panels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.kernels.panel_reduce import panel_mean_consensus
from repro_torch.utils.tree import tree_flatten, tree_unflatten


@dataclass(frozen=True)
class LeafSpec:
    group: str            # dtype-group key ('float32', 'bfloat16', ...)
    offset: int           # column offset inside the group panel
    size: int             # number of scalars per agent
    shape: Tuple[int, ...]  # per-agent (trailing) shape
    dtype: str            # leaf storage dtype name


@dataclass(frozen=True, eq=False)
class PanelSpec:
    """Static description of a panelised tree. ``treedef`` is the tree's
    skeleton (``utils.tree.tree_flatten``)."""
    treedef: object
    leaves: Tuple[LeafSpec, ...]
    groups: Tuple[Tuple[str, int], ...]  # (dtype key, group width D_g)
    rows: int = 0                        # m (agents)
    merger: str = "uniform"              # merge operator of global rounds

    @property
    def width(self) -> int:
        """Total scalars per agent across all dtype groups."""
        return sum(w for _, w in self.groups)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def make_spec(tree, rows: Optional[int] = None) -> PanelSpec:
    """Spec of an agent-stacked tree (leaves (m, ...)), or, with ``rows``,
    of ONE agent's tree (leaves without the agent axis) for an m = rows
    panel."""
    leaves, treedef = tree_flatten(tree)
    lead = 0 if rows is not None else 1
    offsets: dict = {}
    specs = []
    for x in leaves:
        key = dtype_name(x.dtype)
        off = offsets.get(key, 0)
        shape = tuple(x.shape[lead:])
        size = int(np.prod(shape, dtype=np.int64))
        specs.append(LeafSpec(group=key, offset=off, size=size, shape=shape,
                              dtype=key))
        offsets[key] = off + size
    groups = tuple(sorted(offsets.items()))
    if rows is None:
        rows = int(leaves[0].shape[0]) if leaves else 0
    return PanelSpec(treedef=treedef, leaves=tuple(specs), groups=groups,
                     rows=rows)


def to_panel(tree, spec: PanelSpec):
    """Flatten an agent-stacked tree into {dtype: (m, D_dtype)} panels."""
    leaves, _ = tree_flatten(tree)
    m = leaves[0].shape[0]
    parts: dict = {}
    for x, ls in zip(leaves, spec.leaves):
        parts.setdefault(ls.group, []).append(x.reshape(m, ls.size))
    return {k: (fl[0].contiguous() if len(fl) == 1 else torch.cat(fl, dim=1))
            for k, fl in parts.items()}


def write_row(panel, spec: PanelSpec, k: int, tree):
    """Copy ONE agent's tree (leaves without the agent axis) into row k."""
    leaves, _ = tree_flatten(tree)
    for x, ls in zip(leaves, spec.leaves):
        panel[ls.group][k, ls.offset:ls.offset + ls.size] = x.reshape(-1)


def from_panel(panel, spec: PanelSpec, cast: bool = True):
    """Rebuild the tree from panels. (m, D) panels give a stacked tree;
    (D,) panels (a merged model) give leaves without the agent axis. The
    leaves are views of the panel. ``cast=False`` keeps the panel dtype."""
    outs = []
    for ls in spec.leaves:
        g = panel[ls.group]
        if g.dim() == 2:
            x = g[:, ls.offset:ls.offset + ls.size]
            x = x.reshape((g.shape[0],) + ls.shape)
        else:
            x = g[ls.offset:ls.offset + ls.size].reshape(ls.shape)
        outs.append(x.to(_torch_dtype(ls.dtype)) if cast else x)
    return tree_unflatten(spec.treedef, outs)


def agent_params(panel, spec: PanelSpec, k: int):
    """Agent k's parameter tree as views of its panel row."""
    return from_panel({g: x[k] for g, x in panel.items()}, spec)


# ------------------------------------------------------------ fused ops


def _device_w(W, device):
    return torch.as_tensor(W, dtype=torch.float32,
                           device=device).contiguous()


def _mix_dense_groups(panel, W, *, with_mean):
    """Shared body of mix_dense / mix_dense_mean: (mixed, means or None).

    ``with_mean`` augments W with a 1^T/m row so the column mean comes out
    of the SAME sweep; the first m output rows are the plain mix."""
    x0 = next(iter(panel.values()))
    m = x0.shape[0]
    W32 = _device_w(W, x0.device)
    if W32.shape != (m, m):
        raise ValueError(f"W must be ({m}, {m}), got {tuple(W32.shape)}")
    Wop = (torch.cat([W32, torch.full((1, m), 1.0 / m, dtype=torch.float32,
                                      device=x0.device)])
           if with_mean else W32)
    mixed, means = {}, ({} if with_mean else None)
    for k, x in panel.items():
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"group {k!r}: the port's mix carries float32 panels only "
                "(the bf16 wire is a later slice)")
        y = gossip_mix(Wop, x)
        mixed[k] = y[:m]
        if with_mean:
            means[k] = y[m]
    return mixed, means


def mix_dense(panel, W):
    """Theta <- W Theta, one float32 sweep per dtype group."""
    return _mix_dense_groups(panel, W, with_mean=False)[0]


def mix_dense_mean(panel, W):
    """mix_dense with the consensus mean folded into the mixing sweep.

    Returns ``(mixed, mean, None)`` — mean is {group: (D_g,) f32}, the
    column mean of the mixed panel (exact for doubly-stochastic W), ready
    for :func:`consensus_from_mean`. The third slot (the reference's
    error-feedback residual) is None on the float32 wire."""
    mixed, means = _mix_dense_groups(panel, W, with_mean=True)
    return mixed, means, None


def global_merge(panel):
    """theta_k <- mean_l theta_l for every row."""
    return {k: mu[None].expand(x.shape).to(x.dtype).contiguous()
            for (k, x), mu in zip(panel.items(), merged(panel).values())}


def merged(panel):
    """The (counterfactual) averaged model as {dtype: (D_dtype,)} f32."""
    return {k: panel_mean_consensus(x.to(torch.float32))[0]
            for k, x in panel.items()}


def consensus_distance(panel):
    """Xi_t = sqrt((1/m) sum_k ||theta_k - bar||^2), a float32 scalar."""
    x0 = next(iter(panel.values()))
    m = x0.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=x0.device)
    for x in panel.values():
        total = total + panel_mean_consensus(x.to(torch.float32))[1]
    return torch.sqrt(total / m)


def consensus_from_mean(panel, means):
    """Xi_t from a PRECOMPUTED column-mean panel ({group: (D_g,) f32},
    e.g. the folded row of :func:`mix_dense_mean`): one deviation pass,
    taken a row at a time so no (m, D) temporary is made."""
    x0 = next(iter(panel.values()))
    m = x0.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=x0.device)
    for k, x in panel.items():
        for r in range(m):
            total = total + torch.sum(torch.square(
                x[r].to(torch.float32) - means[k]))
    return torch.sqrt(total / m)


def panel_norm(panel, axis_mean: bool = False):
    """Global l2 norm of the panel (f32). With ``axis_mean`` the rows are
    averaged first (norm of the agent-mean, e.g. for grad-norm metrics)."""
    x0 = next(iter(panel.values()))
    total = torch.zeros((), dtype=torch.float32, device=x0.device)
    for x in panel.values():
        x32 = x.to(torch.float32)
        if axis_mean:
            x32 = torch.mean(x32, dim=0)
        total = total + torch.sum(torch.square(x32))
    return torch.sqrt(total)
