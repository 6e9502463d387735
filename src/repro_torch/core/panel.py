"""Flat-panel parameter engine (counterpart of ``repro/core/panel.py``).

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
* :func:`mix_pairwise` — theta_k <- (1-w) theta_k + w theta_{partner[k]} for
  a (partial) matching: one row gather and one weighted sum per group.
* :func:`global_merge`, :func:`merged` / :func:`consensus_distance` — the
  column mean and the consensus distance Xi through the
  ``panel_mean_consensus`` kernel; with ``live=`` (an elastic run's (m,)
  mask) the mean of the live rows (the kernel on the gathered live rows)
  and their consensus (a float64 row pass, exactly 0 for identical rows).

The merge operator of global rounds is named on the spec
(:func:`with_merger`, ``repro_torch.merging``).

The payload travels through the spec's wire policy (:func:`with_wire`,
``repro_torch.wire``): the float32 identity, ``bf16`` (the mix reads the
bf16 payload through the ``gossip_mix`` kernel's bf16 variant and rounds
its rows back through bf16), ``int8`` / ``int8_ef`` and ``int4`` /
``int4_ef`` (per-row int8 or grouped packed int4 with stochastic rounding,
without and with the error-feedback residual; the quantize, dequantize,
pack and unpack kernels) and ``topk`` (the sparse innovation over a mirror
panel through ``sparsify_topk``, mixed in damped delta form).

The residency policy of the state panels (:func:`with_residency`,
``repro_torch.residency``) is named on the spec too; it never applies to
the parameter panels. The reference's legacy ``wire_dtype=`` argument (a
cast of the payload, e.g. bf16) is taken by every communication op in place
of a spec policy; passing both raises. The dense mix takes float32
parameter groups: groups of another dtype come with the architecture
families that have them, and sharded panels with a later slice.

On CUDA tensors the kernel wrappers launch the Hopper kernels; on CPU
tensors they run the plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import wire as wire_mod
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
    wire: Tuple[Tuple[str, object], ...] = ()  # (dtype key, codec) policy
    residency: Tuple[Tuple[str, str], ...] = ()  # (state kind, storage)

    @property
    def width(self) -> int:
        """Total scalars per agent across all dtype groups."""
        return sum(w for _, w in self.groups)

    def wire_of(self, key: str):
        """Codec (name or instance) of one dtype group; 'f32' when no
        policy is set."""
        for k, name in self.wire:
            if k == key:
                return name
        return "f32"

    @property
    def wire_payload_bytes(self) -> int:
        """Per-agent wire bytes of the transmitted VALUES alone for one
        full-panel exchange (scale/index metadata excluded)."""
        return sum(wire_mod.get_codec(self.wire_of(k)).payload_bytes(1, w, k)
                   for k, w in self.groups)

    @property
    def wire_total_bytes(self) -> int:
        """Per-agent wire bytes INCLUDING codec metadata (per-row int8
        scales, packed top-k indices): what crosses the wire per
        exchange."""
        return sum(wire_mod.get_codec(self.wire_of(k)).total_bytes(1, w, k)
                   for k, w in self.groups)


    def residency_of(self, kind: str) -> str:
        """Storage name of one state-panel kind ('moments', 'stats',
        'wire_err'); 'f32' when no policy is set."""
        for k, name in self.residency:
            if k == kind:
                return name
        return "f32"

    def storage_bytes(self, kind: str, state_dtype: Optional[str] = None
                      ) -> int:
        """Exact per-agent resident bytes of ONE state panel of ``kind``
        under the residency policy, scales included. Storage codecs act on
        float32 state only: with ``state_dtype=None`` the state mirrors each
        group's dtype (the optimizer moments) and a non-float32 group pays
        its itemsize; ``state_dtype='float32'`` models the panels that are
        float32 for every group (merge statistics, error-feedback panels).
        """
        from repro_torch import residency as residency_mod
        st = residency_mod.get_storage(self.residency_of(kind))
        total = 0
        for g, w in self.groups:
            dt = state_dtype or g
            if dt == "float32":
                total += st.resident_bytes(1, w)
            else:
                total += wire_mod.codec._itemsize(dt) * w
        return total


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


def with_wire(spec: PanelSpec, wire) -> PanelSpec:
    """Attach a wire-codec policy to ``spec``.

    ``wire`` is a codec (a ``repro_torch.wire.CODECS`` name or a codec
    instance) for EVERY dtype group, or a {dtype-group: codec} dict (unlisted
    groups fall back to 'f32'); None clears the policy. Codecs are resolved
    here, so a typo fails when the spec is built."""
    if wire is None:
        return replace(spec, wire=())
    if isinstance(wire, dict):
        unknown = set(wire) - {k for k, _ in spec.groups}
        if unknown:
            raise ValueError(
                f"wire policy names unknown dtype groups {sorted(unknown)}"
                f"; this spec's groups: {[k for k, _ in spec.groups]}")
        mapping = {k: wire.get(k, "f32") for k, _ in spec.groups}
    else:
        mapping = {k: wire for k, _ in spec.groups}
    for name in mapping.values():
        wire_mod.get_codec(name)
    return replace(spec, wire=tuple(sorted(mapping.items())))


def with_residency(spec: PanelSpec, residency) -> PanelSpec:
    """Attach a storage-codec residency policy to ``spec``.

    ``residency`` is a {state kind: storage name} dict or a policy string
    for ``residency.parse_policy`` ('moments=int8,stats=bf16', or a bare
    storage name for the moments); kinds are 'moments', 'stats' and
    'wire_err' (parameters keep their dtype), names are
    ``residency.STORAGE`` keys. Explicit 'f32' entries are dropped: the f32
    policy IS the empty policy. None clears. Only registry NAMES live on
    the spec."""
    if residency is None:
        return replace(spec, residency=())
    from repro_torch import residency as residency_mod
    named = {}
    for kind, name in residency_mod.parse_policy(residency).items():
        if not isinstance(name, str):
            raise ValueError(
                "with_residency takes registry NAMES; register a custom "
                "Storage instance in residency.STORAGE first")
        st = residency_mod.get_storage(name)
        if st.name != "f32":
            named[kind] = st.name
    return replace(spec, residency=tuple(sorted(named.items())))


def with_merger(spec: PanelSpec, merger) -> PanelSpec:
    """Attach a merge operator, by its ``merging.MERGERS`` registry name, to
    ``spec``: the operator every GLOBAL round applies (the paper's single
    final merging included). Validated here, so a typo fails when the spec
    is built; None resets to 'uniform'. A ``Merger`` instance raises: the
    spec names registry entries only, so register a configured instance
    first (``merging.MERGERS['my_ties'] = TiesMerger(trim=0.5)``) and pass
    its name."""
    if merger is None:
        return replace(spec, merger="uniform")
    from repro_torch import merging as merging_mod  # merging imports panel
    resolved = merging_mod.get_merger(merger)
    if not isinstance(merger, str):
        raise ValueError(
            "with_merger takes a registry NAME. To use a configured "
            f"instance, register it first — merging.MERGERS['my_"
            f"{resolved.name}'] = instance — and pass that name; the "
            f"registry entry {resolved.name!r} may carry other "
            "hyperparameters than your instance")
    return replace(spec, merger=merger)


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


def _codecs(panel, spec: Optional[PanelSpec], wire_dtype=None):
    """Codec of each dtype group for one communication op: the legacy
    ``wire_dtype`` cast when given (it refuses to combine with a spec
    policy: one compression authority a call), else the spec's wire policy,
    else the float32 identity (shared with merging.merge_panel)."""
    if wire_dtype is not None:
        if spec is not None and spec.wire:
            raise ValueError("pass either wire_dtype= (legacy cast) or a "
                             "spec wire policy (with_wire), not both")
        c = wire_mod.dtype_codec(wire_dtype)
        return {k: c for k in panel}
    if spec is not None and spec.wire:
        return {k: wire_mod.get_codec(spec.wire_of(k)) for k in panel}
    f32 = wire_mod.CODECS["f32"]
    return {k: f32 for k in panel}


def _require_gen(codecs, gen):
    """Stochastic codecs draw from ``gen``: the groups encode in sorted
    order, one uniform draw each per communicating round (the counterpart
    of the reference's per-group key fold)."""
    names = sorted(k for k, c in codecs.items() if c.needs_key)
    if names and gen is None:
        raise ValueError(f"wire codecs for groups {names} use stochastic "
                         "rounding and need a torch.Generator (gen=...)")


def _idle_rows(W, m):
    """Rows of W equal to the identity row: agents that send nothing."""
    Wh = np.asarray(torch.as_tensor(W, dtype=torch.float32).cpu())
    eye = np.eye(m, dtype=np.float32)
    return [r for r in range(m) if np.array_equal(Wh[r], eye[r])]


def _mix_dense_groups(panel, W, *, with_mean, spec=None, gen=None,
                      err=None, wire_dtype=None):
    """Shared body of mix_dense / mix_dense_mean: (mixed, means or None,
    new_err or None).

    ``with_mean`` augments W with a 1^T/m row so the column mean of the
    transmitted panel comes out of the SAME sweep; the first m output rows
    are the plain mix. Each group's payload is encoded by its codec first;
    a delta codec (topk) mixes as x + gamma (W - I) @ x̂ instead, with the
    mean taken off the mixed panel. A payload narrower than float32 (bf16)
    is mixed into float32 rows, which are then rounded through the payload
    dtype and cast back by the codec, as the reference's plain path does;
    the folded mean row stays float32 (the reference's fold rule), so the
    consensus monitor measures the rounded rows against the unrounded mean.
    Under a lossy codec, idle ROWS of W (rows equal to the identity row)
    get back their exact parameters and error-feedback rows: nothing of
    theirs travelled."""
    x0 = next(iter(panel.values()))
    m = x0.shape[0]
    W32 = _device_w(W, x0.device)
    if W32.shape != (m, m):
        raise ValueError(f"W must be ({m}, {m}), got {tuple(W32.shape)}")
    codecs = _codecs(panel, spec, wire_dtype)
    _require_gen(codecs, gen)
    lossy = any(not isinstance(c, wire_mod.F32Codec)
                for c in codecs.values())
    idle = _idle_rows(W, m) if lossy else []
    Wop = (torch.cat([W32, torch.full((1, m), 1.0 / m, dtype=torch.float32,
                                      device=x0.device)])
           if with_mean else W32)
    mixed, means = {}, ({} if with_mean else None)
    new_err = {} if err is not None else None
    for k in sorted(panel):
        x = panel[k]
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"group {k!r} is stored as {x.dtype}: the port mixes float32 "
                "parameter groups (groups of other dtypes come with the "
                "architecture families that have them)")
        e = err[k] if err is not None else None
        xw, back, ne = codecs[k].encode(x, gen=gen, err=e)
        if codecs[k].delta_mix:
            # CHOCO's damped delta form x + gamma (W - I) @ x̂: a sparse
            # payload mixed as W @ Q(x) would zero every coordinate that
            # did not travel
            Wd = W32 - torch.eye(m, dtype=torch.float32, device=x.device)
            y = gossip_mix(Wd, xw).mul_(codecs[k].gamma).add_(x)
            del xw
            if with_mean:
                means[k] = panel_mean_consensus(y)[0]
        else:
            y = gossip_mix(Wop, xw)
            wire_dtype = xw.dtype
            del xw
            if with_mean:
                means[k] = y[m]
                y = y[:m]
            if wire_dtype != torch.float32:
                # the payload dtype's rounding, a row at a time in place
                for r in range(m):
                    y[r].copy_(y[r].to(wire_dtype))
            y = back(y)
        for r in idle:
            y[r].copy_(x[r])
            if e is not None:
                ne[r].copy_(e[r])
        mixed[k] = y
        if err is not None:
            new_err[k] = ne
    return mixed, means, new_err


def mix_dense(panel, W, *, wire_dtype=None, spec: Optional[PanelSpec] = None,
              gen=None, err=None):
    """Theta <- W Theta, one float32 sweep per dtype group, the payload
    compressed by the spec's wire policy or the legacy ``wire_dtype`` cast
    (stochastic codecs draw from ``gen``). Passing ``err=`` (the
    error-feedback panel, {group: (m, D_g) f32}) switches the return to
    ``(mixed, new_err)``."""
    mixed, _, new_err = _mix_dense_groups(panel, W, with_mean=False,
                                          spec=spec, gen=gen, err=err,
                                          wire_dtype=wire_dtype)
    return mixed if err is None else (mixed, new_err)


def mix_dense_mean(panel, W, *, wire_dtype=None,
                   spec: Optional[PanelSpec] = None, gen=None, err=None):
    """mix_dense with the consensus mean folded into the mixing sweep.

    Returns ``(mixed, mean, new_err)`` — mean is {group: (D_g,) f32}, the
    column mean of the mixed panel (exact for doubly-stochastic W), ready
    for :func:`consensus_from_mean`; new_err is None when ``err`` is."""
    return _mix_dense_groups(panel, W, with_mean=True, spec=spec, gen=gen,
                             err=err, wire_dtype=wire_dtype)


def _lerp(xw, peer, weight):
    """(1-w) xw + w peer in the payload's dtype, the weights first rounded
    to it (as the reference's weakly typed scalars are)."""
    a, b = (torch.tensor(v, dtype=xw.dtype, device=xw.device)
            for v in (1.0 - weight, weight))
    return a * xw + b * peer


def mix_pairwise(panel, partner, weight=0.5, *, wire_dtype=None,
                 spec: Optional[PanelSpec] = None, gen=None, err=None):
    """theta_k <- (1-w) theta_k + w theta_{partner[k]}: one row gather and
    one weighted sum per dtype group. partner[k] == k means agent k idles
    this round: idle rows keep their EXACT parameters (and error-feedback
    rows), since nothing of theirs travels. The payload goes through the
    codecs of :func:`mix_dense`; a delta (mirror) codec pulls toward the
    partner's mirror, x + gamma w (x̂_partner - x̂), keeping the
    untransmitted rest of x. ``err=`` switches the return to ``(mixed,
    new_err)``."""
    codecs = _codecs(panel, spec, wire_dtype)
    _require_gen(codecs, gen)
    x0 = next(iter(panel.values()))
    m = x0.shape[0]
    part = np.asarray(torch.as_tensor(partner).cpu(), np.int64).reshape(m)
    idle = np.flatnonzero(part == np.arange(m)).tolist()
    index = torch.as_tensor(part, device=x0.device)
    mixed, new_err = {}, ({} if err is not None else None)
    for k in sorted(panel):
        x = panel[k]
        e = err[k] if err is not None else None
        xw, back, ne = codecs[k].encode(x, gen=gen, err=e)
        peer = torch.index_select(xw, 0, index)
        if codecs[k].delta_mix:
            y = back(x.to(torch.float32)
                     + codecs[k].gamma * weight * (peer - xw))
        else:
            y = back(_lerp(xw, peer, weight))
        del xw, peer
        for r in idle:
            y[r].copy_(x[r])
            if e is not None:
                ne[r].copy_(e[r])
        mixed[k] = y
        if err is not None:
            new_err[k] = ne
    return mixed if err is None else (mixed, new_err)


def global_merge(panel, *, wire_dtype=None, spec: Optional[PanelSpec] = None,
                 gen=None, err=None):
    """theta_k <- mean_l theta_l for every row, the payload through the
    spec's wire policy — EXCEPT delta (mirror) codecs: the global merge is
    their full-bandwidth round, so the exact panel travels and the mirror
    resets to the merged state. It is ``merging.merge_panel`` under the
    uniform operator; ``wire_dtype`` as in :func:`mix_dense`. ``err=``
    switches the return to ``(mixed, new_err)``."""
    from repro_torch.merging import merge_panel  # merging imports panel
    mixed, _, new_err = merge_panel(panel, "uniform", spec=spec, gen=gen,
                                    err=err, wire_dtype=wire_dtype)
    return mixed if err is None else (mixed, new_err)


def _live_mask(live, m):
    """An (m,) host bool array of a live mask (a tensor, an array or a
    list)."""
    if torch.is_tensor(live):
        live = live.cpu().numpy()
    return np.asarray(live, dtype=bool).reshape(m)


def _live_weights(live, m, device=None):
    """(m,) float32 convex weights over the live rows of an (m,) bool mask;
    an all-dead mask gives zeros, not NaN."""
    lf = torch.as_tensor(_live_mask(live, m), dtype=torch.float32,
                         device=device)
    return lf / torch.clamp(torch.sum(lf), min=1.0)


def merged(panel, live=None):
    """The (counterfactual) averaged model as {dtype: (D_dtype,)} f32.

    ``live`` ((m,) bool) restricts the mean to the live rows (the merge of
    an elastic run, where a dead agent's stale row must not enter it): the
    live rows are gathered into a sub-panel and reduced by the unmasked
    ``panel_mean_consensus`` kernel, so the result is the sub-panel's mean
    (the reference takes the live-weighted sum; the two agree to float32
    rounding). No live row gives zeros."""
    if live is None:
        return {k: panel_mean_consensus(x.to(torch.float32))[0]
                for k, x in panel.items()}
    x0 = next(iter(panel.values()))
    m = x0.shape[0]
    rows = np.flatnonzero(_live_mask(live, m))
    out = {}
    for k, x in panel.items():
        if not len(rows):
            out[k] = torch.zeros(x.shape[1], dtype=torch.float32,
                                 device=x.device)
            continue
        sub = x if len(rows) == m else x[torch.as_tensor(rows,
                                                         device=x.device)]
        out[k] = panel_mean_consensus(sub.to(torch.float32))[0]
        del sub
    return out


def merged_tree(panel, spec: PanelSpec):
    """The averaged model as a (non-stacked) tree with float32 leaves: the
    panel counterpart of ``gossip.merged_model``."""
    return from_panel(merged(panel), spec, cast=False)


def consensus_distance(panel, live=None):
    """Xi_t = sqrt((1/m) sum_k ||theta_k - bar||^2), a float32 scalar.

    ``live`` ((m,) bool) takes the consensus of the live rows only: their
    mean, their deviations, over the live count. That mean and the sum of
    squares are taken in float64 a row at a time (no (m, D) temporary), so
    identical live rows read exactly 0 whatever the live count (a float32
    mean of 7 equal rows need not equal the row)."""
    x0 = next(iter(panel.values()))
    m = x0.shape[0]
    if live is not None:
        rows = np.flatnonzero(_live_mask(live, m))
        total = torch.zeros((), dtype=torch.float64, device=x0.device)
        for x in panel.values() if len(rows) else ():
            mean = torch.zeros(x.shape[1], dtype=torch.float64,
                               device=x.device)
            for r in rows:
                mean += x[r]
            mean /= len(rows)
            for r in rows:
                total = total + torch.sum(torch.square(x[r].double() - mean))
            del mean
        return torch.sqrt(total / max(len(rows), 1)).to(torch.float32)
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


def panel_norm(panel, axis_mean: bool = False, rows=None):
    """Global l2 norm of the panel (f32). With ``axis_mean`` the rows are
    averaged first (norm of the agent-mean, e.g. for grad-norm metrics);
    ``rows`` ((m,) float32 convex weights, e.g. :func:`_live_weights` of a
    live mask) replaces the uniform mean by the weighted one: the grad norm
    of an elastic round averages the live agents only."""
    x0 = next(iter(panel.values()))
    total = torch.zeros((), dtype=torch.float32, device=x0.device)
    for x in panel.values():
        x32 = x.to(torch.float32)
        if axis_mean:
            x32 = (torch.mean(x32, dim=0) if rows is None else
                   torch.matmul(rows.to(x32.device), x32))
        total = total + torch.sum(torch.square(x32))
    return torch.sqrt(total)
