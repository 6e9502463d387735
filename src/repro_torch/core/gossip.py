"""Gossip mixing of agent-stacked parameter trees (counterpart of
``repro/core/gossip.py``).

Every leaf of an agent-stacked tree has shape (m, ...). The public functions
are backed by the flat-panel engine (core/panel.py): the tree is flattened
into per-dtype (m, D) panels and each mixing form runs ONE fused op per dtype
group instead of one op per leaf:

* :func:`mix_dense` — Theta <- W Theta for any doubly-stochastic W (W = I
  included): the ``gossip_mix`` kernel on the card.
* :func:`mix_pairwise` — theta_k <- (1-w) theta_k + w theta_{partner[k]}
  for a (partial) matching: one row gather per group.
* :func:`global_merge` — the mean over the agent axis broadcast back (the
  paper's single final merging).
* :func:`merged_model` — the averaged model with the agent axis dropped:
  the ``panel_mean_consensus`` kernel on the card.

``wire_dtype`` casts the payload for the exchange only (the reference's
legacy bf16 lever); ``wire`` names a codec of ``repro_torch.wire`` instead
('f32', 'bf16', 'int8', 'int4'; the stochastic ones draw from ``gen``, a
``torch.Generator``). On the per-leaf ``*_tree`` path codecs apply leaf by
leaf (each leaf reshaped to its (m, size) panel, so int8 scales are per
agent and LEAF, and int4 group scales tile each leaf separately); the leaves
encode in tree order, each drawing its uniforms from ``gen`` in turn, or
taking them from ``u`` (a list of (m, size) float32 tensors, one a leaf:
how the tests feed the reference's draws). Codecs that carry state are
refused on both paths: error feedback needs the panel engine's residual
panel, and the mirror of topk its delta mix.

The per-leaf ``*_tree`` functions are the reference the panel path is held
against, and the tree-state driver's mix (``core/dsgd.py``): plain
``torch.tensordot`` a leaf, no kernel. :func:`global_merge_allreduce` is
the counterpart of the reference's shard_map merge (``global_merge_shmap``):
the agent rows spread over the ranks of a mesh, one all-reduce a leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import wire as wire_mod
from repro_torch.core import panel as panel_mod
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def _via_panel(op, params, wire=None):
    spec = panel_mod.make_spec(params)
    if wire is not None:
        if wire_mod.get_codec(wire).error_feedback:
            raise ValueError(
                f"codec '{wire}' needs an error-feedback residual, which "
                "these stateless wrappers cannot carry; use the panel "
                "engine (dsgd.make_panel_segment) or 'int8'")
        spec = panel_mod.with_wire(spec, wire)
    return panel_mod.from_panel(op(panel_mod.to_panel(params, spec), spec),
                                spec)


def mix_dense(params, W, wire_dtype=None, wire=None, gen=None):
    """Theta <- W Theta (row k: sum_l W[k,l] theta_l): one fused sweep per
    dtype group over the flattened panel."""
    return _via_panel(
        lambda p, s: panel_mod.mix_dense(p, W, wire_dtype=wire_dtype,
                                         spec=s, gen=gen), params, wire)


def mix_pairwise(params, partner, weight=0.5, wire_dtype=None, wire=None,
                 gen=None):
    """theta_k <- (1-w) theta_k + w theta_{partner[k]}; partner: (m,) ints.
    partner[k] == k means agent k idles this round (no communication)."""
    return _via_panel(
        lambda p, s: panel_mod.mix_pairwise(p, partner, weight,
                                            wire_dtype=wire_dtype, spec=s,
                                            gen=gen), params, wire)


def global_merge(params, wire_dtype=None, wire=None, gen=None):
    """Single global merging: theta_k <- mean_l theta_l for every k."""
    return _via_panel(
        lambda p, s: panel_mod.global_merge(p, wire_dtype=wire_dtype,
                                            spec=s, gen=gen), params, wire)


def merged_model(params):
    """The (counterfactual) globally averaged model: the agent axis
    dropped, float32 leaves; one fused mean per dtype group."""
    spec = panel_mod.make_spec(params)
    return panel_mod.merged_tree(panel_mod.to_panel(params, spec), spec)


# ---------------------------------------------------------------------------
# Per-leaf reference path.
# ---------------------------------------------------------------------------


def _leaf_codec(wire_dtype, wire):
    """Codec shared by every leaf of one tree-path call (the legacy
    ``wire_dtype`` wins, as in panel._codecs). Error-feedback codecs are
    refused: this path carries no residual, so accepting them would
    silently degrade int8_ef to plain int8."""
    if wire_dtype is not None:
        if wire is not None:
            raise ValueError("pass either wire_dtype= or wire=, not both")
        return wire_mod.dtype_codec(wire_dtype)
    codec = wire_mod.get_codec(wire if wire is not None else "f32")
    if codec.error_feedback:
        raise ValueError(
            f"codec '{codec.name}' needs an error-feedback residual, which "
            "the per-leaf tree path cannot carry; use the panel engine "
            "(dsgd.make_panel_segment) or a residual-free codec ('int8')")
    if codec.delta_mix:
        # no registry codec reaches this (topk is error feedback too), but
        # a residual-free delta codec would: this path mixes W @ payload
        raise ValueError(
            f"codec '{codec.name}' mixes in delta (mirror) form, which "
            "the per-leaf tree path does not implement; use the panel "
            "engine (dsgd.make_panel_segment)")
    return codec


def _encode_leaf(codec, x, gen, u=None):
    """Apply a codec to one (m, ...) leaf: flattened to the leaf's (m, size)
    panel (int8 scales are per agent and leaf here), reshaped back."""
    m = x.shape[0]
    xw, back, _ = codec.encode(x.reshape(m, -1),
                               gen=gen if codec.needs_key else None, u=u)
    return xw.reshape((xw.shape[0],) + tuple(x.shape[1:])), back


def _leaf_u(u, i):
    return None if u is None else u[i]


def _rows(mask, x):
    """An (m,) bool host mask as a broadcastable mask for leaf ``x``."""
    return torch.as_tensor(mask, device=x.device).reshape(
        (x.shape[0],) + (1,) * (x.dim() - 1))


def _tree_map_wire(fn, params, codec, gen, u):
    leaves, skel = tree_flatten(params)
    outs = []
    for i, x in enumerate(leaves):
        xw, back = _encode_leaf(codec, x, gen, _leaf_u(u, i))
        outs.append(back(fn(xw)))
    return tree_unflatten(skel, outs)


def _mix_leaf(W32, xw):
    """W @ one leaf's payload: float32 as it is; a narrower payload (bf16)
    against W cast to the payload dtype (the reference's tensordot of
    ``W.astype(xw.dtype)``), its products summed in float32 and rounded once
    to the payload dtype."""
    if xw.dtype == torch.float32:
        return torch.tensordot(W32, xw, dims=1)
    return torch.tensordot(W32.to(xw.dtype).to(torch.float32),
                           xw.to(torch.float32), dims=1).to(xw.dtype)


def mix_dense_tree(params, W, wire_dtype=None, wire=None, gen=None,
                   u=None):
    """Per-leaf Theta <- W Theta: one tensordot per leaf. Idle ROWS of W
    (rows equal to the identity row, e.g. unmatched agents in a matching)
    communicate nothing: under a lossy codec they keep their exact
    parameters (as panel.mix_dense)."""
    codec = _leaf_codec(wire_dtype, wire)
    leaves, skel = tree_flatten(params)
    m = leaves[0].shape[0]
    W32 = torch.as_tensor(W, dtype=torch.float32,
                          device=leaves[0].device).contiguous()
    idle = ([] if isinstance(codec, wire_mod.F32Codec)
            else panel_mod._idle_rows(W, m))
    outs = []
    for i, x in enumerate(leaves):
        xw, back = _encode_leaf(codec, x, gen, _leaf_u(u, i))
        y = back(_mix_leaf(W32, xw))
        del xw
        for r in idle:
            y[r].copy_(x[r])
        outs.append(y)
    return tree_unflatten(skel, outs)


def mix_pairwise_tree(params, partner, weight=0.5, wire_dtype=None,
                      wire=None, gen=None, u=None):
    """Per-leaf pairwise exchange: one row gather per leaf. Idle rows
    (partner[k] == k) keep their exact parameters: no codec touches them
    (as panel.mix_pairwise)."""
    codec = _leaf_codec(wire_dtype, wire)
    leaves, skel = tree_flatten(params)
    m = leaves[0].shape[0]
    part = np.asarray(torch.as_tensor(partner).cpu(), np.int64).reshape(m)
    idle = part == np.arange(m)
    index = torch.as_tensor(part, device=leaves[0].device)
    outs = []
    for i, x in enumerate(leaves):
        xw, back = _encode_leaf(codec, x, gen, _leaf_u(u, i))
        peer = torch.index_select(xw, 0, index)
        y = back(panel_mod._lerp(xw, peer, weight))
        outs.append(torch.where(_rows(idle, x), x, y))
    return tree_unflatten(skel, outs)


def global_merge_tree(params, wire_dtype=None, wire=None, gen=None,
                      live=None, u=None):
    """Per-leaf global merging: one mean per leaf, broadcast back.

    ``live`` ((m,) bool) restricts the merge to the live agents: the mean
    is over live rows only and ONLY live rows receive it; dead rows pass
    through bit for bit (the tree oracle of the engine's masked global
    rounds)."""
    codec = _leaf_codec(wire_dtype, wire)
    if live is None:
        def leaf(xw):
            mean = torch.mean(xw.to(torch.float32), dim=0, keepdim=True)
            return mean.expand(xw.shape).to(xw.dtype).contiguous()

        return _tree_map_wire(leaf, params, codec, gen, u)
    leaves, skel = tree_flatten(params)
    m = leaves[0].shape[0]
    alive = panel_mod._live_mask(live, m)
    lw = panel_mod._live_weights(alive, m, leaves[0].device)
    outs = []
    for i, x in enumerate(leaves):
        xw, back = _encode_leaf(codec, x, gen, _leaf_u(u, i))
        mean = torch.tensordot(lw, xw.to(torch.float32), dims=1)
        y = back(mean[None].expand(xw.shape).to(xw.dtype).contiguous())
        outs.append(torch.where(_rows(alive, x), y, x))
    return tree_unflatten(skel, outs)


def merged_model_tree(params, live=None):
    """Per-leaf averaged model (float32 leaves, agent axis dropped).
    ``live`` ((m,) bool) averages the live agents' rows only."""
    if live is None:
        return tree_map(lambda x: torch.mean(x.to(torch.float32), dim=0),
                        params)
    x0 = tree_flatten(params)[0][0]
    lw = panel_mod._live_weights(live, x0.shape[0], x0.device)
    return tree_map(
        lambda x: torch.tensordot(lw, x.to(torch.float32), dims=1), params)


def global_merge_allreduce(params, mesh):
    """The global merge of an agent-stacked tree whose rows are spread over
    the ``rows`` line of ``mesh`` (``launch.mesh``): each leaf holds this
    rank's (m_local, ...) agents, m = m_local x the line's ranks. One sum of
    the local rows, one all-reduce of it over the line, divided by m and
    broadcast back to the local rows (float32 sums, cast back to each
    leaf's dtype): every rank ends with the mean of all m agents."""
    n = len(mesh.members["rows"])

    def leaf(x):
        tot = mesh.all_reduce(torch.sum(x.to(torch.float32), dim=0), "rows")
        mean = tot / (x.shape[0] * n)
        return mean[None].expand(x.shape).to(x.dtype).contiguous()

    return tree_map(leaf, params)
