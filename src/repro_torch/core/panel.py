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

Sharded panels (:func:`shard_spec`, ``launch/mesh.py``): a rank holds its
agents' rows x its columns of each group. Every op above takes such a
shard and gives the rank's block of the single-process result: the rows a
column needs are gathered over the mesh's ``rows`` line (a column slab of
``GATHER_SLAB`` at a time where only a column result is wanted), and what
a codec or a storage needs of a whole row comes through the group's
:class:`Shard` (``spec.shard(key)``: the block's place in the panel and
the max, sum and gathers over the ``fsdp`` line). Column results are the
single-process bits; sums over whole rows (Xi, norms) are summed over the
ranks in another order.

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
of a spec policy; passing both raises.

Parameter groups of every dtype the reference groups are taken: float32,
bfloat16 and float16 groups go through the kernels as they are stored (the
mix accumulates in float32 and rounds each row once to the group dtype; the
mean and Xi widen exactly to float32), an int32 group through the plain
versions (on the CPU; the kernels take floating-point panels).

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
from repro_torch.models.sharding import panel_pspec
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
    # set by shard_spec: the mesh (launch.mesh.Mesh) and each group's
    # (row entry, column entry) layout (models.sharding.panel_pspec)
    mesh: object = None
    pspecs: Tuple[Tuple[str, tuple], ...] = ()

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and bool(self.pspecs)

    def pspec(self, key: str):
        for k, ps in self.pspecs:
            if k == key:
                return ps
        return (None, None)

    def _range(self, axes, n: int):
        if axes is None:
            return 0, n
        parts = self.mesh.axis_size(axes)
        i = self.mesh.axis_index(axes)
        return i * (n // parts), (i + 1) * (n // parts)

    def agent_range(self) -> Tuple[int, int]:
        """[lo, hi) of the agents this rank holds (every group's rows
        shard alike: the claim depends on m alone)."""
        return self.row_range(self.groups[0][0])

    def row_range(self, key: str) -> Tuple[int, int]:
        """[lo, hi) of the agent rows this rank holds of group ``key`` (all
        m when the rows are not sharded)."""
        return self._range(self.pspec(key)[0], self.rows)

    def col_range(self, key: str) -> Tuple[int, int]:
        """[lo, hi) of the columns this rank holds of group ``key`` (all
        of them when the columns are not sharded)."""
        return self._range(self.pspec(key)[1], dict(self.groups)[key])

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


    def shard(self, key: str) -> Optional[Shard]:
        """The :class:`Shard` of group ``key`` on a sharded spec, else
        None."""
        if not self.sharded:
            return None
        return Shard(mesh=self.mesh, rows=self.row_range(key),
                     cols=self.col_range(key), m=self.rows,
                     D=dict(self.groups)[key],
                     split=self.pspec(key)[1] is not None)

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


@dataclass(frozen=True, eq=False)
class Shard:
    """A rank's block of one dtype group's (m, D) panel: its rows [r0, r1)
    and columns [c0, c1), and the collectives over the ``fsdp`` line (the
    ranks holding the other columns of the same rows) that give a codec or
    a storage what it would compute over whole rows. ``split`` is whether
    the group's columns are split at all (else the fsdp ops are the
    identity)."""
    mesh: object
    rows: Tuple[int, int]
    cols: Tuple[int, int]
    m: int
    D: int
    split: bool

    def block(self, full):
        """The rank's (r1 - r0, c1 - c0) block of an (m, D) tensor, as a
        contiguous copy."""
        (r0, r1), (c0, c1) = self.rows, self.cols
        return full[r0:r1, c0:c1].contiguous()

    def col_max(self, t):
        """Elementwise max of ``t`` over the fsdp line (in place)."""
        return self.mesh.all_reduce(t, "fsdp", op="max") if self.split else t

    def col_sum(self, t):
        """Elementwise sum of ``t`` over the fsdp line (in place)."""
        return self.mesh.all_reduce(t, "fsdp") if self.split else t

    def _parts(self) -> int:
        return len(self.mesh.members["fsdp"]) if self.split else 1

    def col_gather(self, t):
        """(rows, c) column shards of the same rows -> (rows, D) whole rows
        in column order."""
        if not self.split:
            return t
        F, r = self._parts(), t.shape[0]
        g = self.mesh.all_gather(t.contiguous(), "fsdp")
        return g.view(F, r, -1).permute(1, 0, 2).reshape(r, -1)

    def col_gather_strided(self, t, stride: int):
        """The panel columns 0, stride, 2 stride, ... < D of the rows of
        ``t`` (this rank's (rows, c) shard), i.e. ``whole[:, ::stride]``,
        each rank's part gathered in column order (the parts' lengths
        differ: padded for the gather, cut after)."""
        if not self.split:
            return t[:, ::stride]
        F, w = self._parts(), self.cols[1] - self.cols[0]
        firsts = [(-i * w) % stride for i in range(F)]
        counts = [len(range(f, w, stride)) for f in firsts]
        n = max(counts)
        i = self.cols[0] // w
        mine = t[:, firsts[i]::stride]
        pad = torch.zeros((t.shape[0], n), dtype=t.dtype, device=t.device)
        pad[:, :counts[i]] = mine
        g = self.mesh.all_gather(pad, "fsdp").view(F, t.shape[0], n)
        return torch.cat([g[j, :, :counts[j]] for j in range(F)], dim=1)


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


def shard_spec(spec: PanelSpec, mesh) -> PanelSpec:
    """Attach a mesh (``launch.mesh.Mesh``) and one (row entry, column
    entry) layout per dtype group to ``spec``: rows on the ('pod', 'agent')
    axes, columns on 'fsdp' (the lines the mesh's ``rows`` and ``fsdp``
    groups run along), each dropped for a group whose dim does not divide
    by the axes' size (that group is then replicated along them). Every
    wire codec, merge operator and residency storage runs on the shards;
    a split of columns that a block-local layout cannot take is refused
    (:func:`check_shard_alignment`)."""
    pspecs = tuple((k, panel_pspec(mesh, spec.rows, w))
                   for k, w in spec.groups)
    spec = replace(spec, mesh=mesh, pspecs=pspecs)
    check_shard_alignment(spec)
    return spec


def check_shard_alignment(spec: PanelSpec):
    """Refuse (ValueError, by name) a column split that a codec or a
    storage cannot take block by block: the kernel-drawn int8 quantize
    keys its draws by 512-column blocks, int4 and the grouped int8
    storages keep a scale per ``group`` columns, so each column shard must
    start on such a boundary (at olmo-1b's D / 2 = 118,751,232 =
    231,936 x 512 it does)."""
    from repro_torch import residency as residency_mod
    from repro_torch.kernels.ref import NATIVE_BLOCK
    for k, D in spec.groups:
        sh = spec.shard(k)
        if sh is None or not sh.split:
            continue
        w = sh.cols[1] - sh.cols[0]
        need = []
        c = wire_mod.get_codec(spec.wire_of(k))
        if isinstance(c, wire_mod.Int8Codec) and c.stochastic \
                and c.draws == "kernel":
            need.append((f"the wire codec '{c.name}' (kernel draws)",
                         NATIVE_BLOCK))
        if isinstance(c, wire_mod.Int4Codec):
            need.append((f"the wire codec '{c.name}'", c.group))
        for kind, name in spec.residency:
            st = residency_mod.get_storage(name)
            if getattr(st, "group", None) and (kind != "moments"
                                               or k == "float32"):
                need.append((f"the {kind} storage '{st.name}'", st.group))
        for what, mult in need:
            if w % mult:
                raise ValueError(
                    f"group {k!r}: {what} needs each column shard to start "
                    f"on a multiple of {mult} columns, but D = {D} splits "
                    f"into shards of {w} columns")


def _claimed(spec: PanelSpec, key: str):
    """(rows sharded, columns sharded) for group ``key``."""
    r, c = spec.pspec(key)
    return r is not None, c is not None


def shard_panel(panel, spec: PanelSpec):
    """A full {group: (m, D_g)} panel -> this rank's shard {group: (rows,
    columns)} (copies)."""
    out = {}
    for k, x in panel.items():
        (r0, r1), (c0, c1) = spec.row_range(k), spec.col_range(k)
        out[k] = x[r0:r1, c0:c1].clone()
    return out


def gather_rows(x, spec: PanelSpec, key: str):
    """Every agent's rows of this rank's column shard of group ``key``:
    the ``rows`` line's shards concatenated in agent order (x itself when
    the rows are not sharded)."""
    return spec.mesh.all_gather(x, "rows") if _claimed(spec, key)[0] else x


def gather_cols(v, spec: PanelSpec, key: str):
    """A (c,) column shard of one row of group ``key`` -> the whole (D_g,)
    row (v itself when the columns are not sharded)."""
    return spec.mesh.all_gather(v, "fsdp") if _claimed(spec, key)[1] else v


def gather_agents(v, spec: PanelSpec):
    """A per-agent (hi - lo,) vector of this rank's agents -> the (m,)
    vector of every agent (v itself when the rows are not sharded)."""
    return gather_rows(v, spec, spec.groups[0][0])


def sum_rows(v, spec: PanelSpec, key: str):
    """The sum of ``v`` over the ranks that hold the other rows of group
    ``key`` (in place; v itself when the rows are not sharded)."""
    return spec.mesh.all_reduce(v, "rows") if _claimed(spec, key)[0] else v


def gather_panel(panel, spec: PanelSpec):
    """This rank's shard -> the full {group: (m, D_g)} panel on every rank
    (for tests, evals and saving)."""
    out = {}
    for k, x in panel.items():
        rows = gather_rows(x, spec, k)
        out[k] = torch.stack([gather_cols(r.contiguous(), spec, k)
                              for r in rows])
        del rows
    return out


# columns of a rank's shard whose rows are gathered at once where only a
# column result is wanted (8 agents: 134 MB of float32 a slab)
GATHER_SLAB = 1 << 22


def row_slabs(x, spec: PanelSpec, key: str, slab: int = GATHER_SLAB):
    """(lo, hi, rows) for each column slab [lo, hi) of this rank's shard
    ``x`` of group ``key``: every agent's rows of the slab, in agent order
    (gathered over the ``rows`` line; a contiguous copy of x's slab when
    the rows are not sharded)."""
    for lo in range(0, x.shape[1], slab):
        hi = min(lo + slab, x.shape[1])
        yield lo, hi, gather_rows(x[:, lo:hi].contiguous(), spec, key)


def local_rows(spec: PanelSpec, rows):
    """The shard-local indices of the agents ``rows`` (global indices) that
    this rank holds, in order (all of them on an unsharded spec)."""
    lo, hi = (0, spec.rows) if spec is None or not spec.sharded \
        else spec.agent_range()
    return [int(r) - lo for r in rows if lo <= int(r) < hi]


def _col_mean(x, spec: PanelSpec, key: str, rows=None):
    """This rank's column shard of the column mean of group ``key`` (the
    ``panel_mean_consensus`` kernel over the gathered rows, a slab at a
    time; ``rows``: only those agents' rows, global indices)."""
    out = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
    sel = None if rows is None or len(rows) == spec.rows else \
        torch.as_tensor(np.asarray(rows, np.int64), device=x.device)
    for lo, hi, full in row_slabs(x, spec, key):
        sub = full if sel is None else full[sel]
        del full
        out[lo:hi] = panel_mean_consensus(_stat_view(sub))[0]
        del sub
    return out


def _reduce_groups(parts, spec: Optional[PanelSpec], rows: bool = True):
    """Sum of per-group float32 partial sums, each first summed over the
    ranks that hold the other parts of its group on a sharded spec: over
    ``rows`` where the group's rows are sharded (unless ``rows`` is False:
    the partials cover every row), over ``fsdp`` where its columns are."""
    sharded = spec is not None and spec.sharded
    total = None
    for k, v in parts.items():
        if sharded:
            if rows:
                v = sum_rows(v, spec, k)
            if _claimed(spec, k)[1]:
                v = spec.mesh.all_reduce(v, "fsdp")
        total = v if total is None else total + v
    return total


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
    """Agent k's parameter tree as views of its panel row; on a sharded
    spec (k one of this rank's agents) its row gathered over the ``fsdp``
    line."""
    j = k - spec.agent_range()[0]
    return from_panel({g: gather_cols(x[j], spec, g)
                       for g, x in panel.items()}, spec)


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


def host_array(x, dtype):
    """``x`` (a numpy array, a sequence or a tensor) as a numpy array of
    ``dtype``: a host value is converted on the host, a tensor fetched."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy().astype(dtype, copy=False)
    return np.asarray(x, dtype)


def _idle_rows(W, m):
    """Rows of W equal to the identity row: agents that send nothing."""
    Wh = host_array(W, np.float32)
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
    A group stored in another dtype (bfloat16, float16) is mixed the same
    way and its rows rounded once to the group dtype; an int32 group is
    truncated back to int32 (the reference's ``astype``).
    Under a lossy codec, idle ROWS of W (rows equal to the identity row)
    get back their exact parameters and error-feedback rows: nothing of
    theirs travelled."""
    if spec is not None and spec.sharded:
        return _mix_dense_sharded(panel, W, with_mean=with_mean, spec=spec,
                                  gen=gen, wire_dtype=wire_dtype, err=err)
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
            if with_mean:
                means[k] = y[m]
                y = y[:m]
            y = back(_round_rows(y, x, xw, m))
            del xw
        for r in idle:
            y[r].copy_(x[r])
            if e is not None:
                ne[r].copy_(e[r])
        mixed[k] = y
        if err is not None:
            new_err[k] = ne
    return mixed, means, new_err


def _mix_slabs(Wk, xw, spec, key):
    """``gossip_mix(Wk, every agent's rows of xw)`` for this rank's shard
    ``xw`` of group ``key``, a column slab at a time: each slab's rows
    gathered over the ``rows`` line and mixed into the float32 output's
    slab (each column is its own sum, so the slabs give the whole sweep's
    bits, and no (m, c) gathered panel is held)."""
    y = torch.empty((Wk.shape[0], xw.shape[1]), dtype=torch.float32,
                    device=xw.device)
    for lo, hi, full in row_slabs(xw, spec, key):
        y[:, lo:hi] = gossip_mix(Wk, full)
        del full
    return y


def _round_rows(y, x, xw, m=None):
    """The mixed float32 rows ``y`` in the payload's dtype: a narrower wire
    over a float32 group rounds a row at a time in place (the rows stay
    float32); a group of another dtype is rounded once to it."""
    if xw.dtype == torch.float32:
        return y
    if x.dtype == torch.float32:
        for r in range(y.shape[0] if m is None else m):
            y[r].copy_(y[r].to(xw.dtype))
        return y
    return y.to(xw.dtype)


def _mix_dense_sharded(panel, W, *, with_mean, spec, gen=None,
                       wire_dtype=None, err=None):
    """_mix_dense_groups on this rank's shard of a sharded panel: each
    group's payload is encoded on the rank's block (the codec given the
    group's :class:`Shard`, so the block is the single-process payload's
    bits), the ``rows`` line's payloads are gathered into every agent's
    rows of the rank's column shard, a column slab at a time, and a
    ``gossip_mix`` sweep a slab computes the rank's rows of W and, with
    ``with_mean``, the 1^T/m row (every row of the shard is here, so the
    mean is folded into the same sweep as on one process). A delta codec mixes its mirrors in the damped delta form
    and takes the mean of the mixed rows (gathered a column slab at a
    time). Every output row and column is its own fixed-order sum, so the
    result is the single-process one's bits."""
    x0 = next(iter(panel.values()))
    m, dev = spec.rows, x0.device
    W32 = _device_w(W, dev)
    if W32.shape != (m, m):
        raise ValueError(f"W must be ({m}, {m}), got {tuple(W32.shape)}")
    codecs = _codecs(panel, spec, wire_dtype)
    _require_gen(codecs, gen)
    lossy = any(not isinstance(c, wire_mod.F32Codec)
                for c in codecs.values())
    idle = _idle_rows(W, m) if lossy else []
    mean_row = torch.full((1, m), 1.0 / m, dtype=torch.float32, device=dev)
    mixed, means = {}, ({} if with_mean else None)
    new_err = {} if err is not None else None
    for k in sorted(panel):
        x = panel[k]
        e = err[k] if err is not None else None
        lo, hi = spec.row_range(k)
        xw, back, ne = codecs[k].encode(x, gen=gen, err=e,
                                        shard=spec.shard(k))
        if codecs[k].delta_mix:
            Wd = W32 - torch.eye(m, dtype=torch.float32, device=dev)
            y = _mix_slabs(Wd[lo:hi].contiguous(), xw, spec, k)
            del xw
            y.mul_(codecs[k].gamma).add_(x)
            if with_mean:
                means[k] = _col_mean(y, spec, k)
        else:
            Wk = W32[lo:hi]
            if with_mean:
                Wk = torch.cat([Wk, mean_row])
            y = _mix_slabs(Wk.contiguous(), xw, spec, k)
            if with_mean:
                means[k] = y[hi - lo].clone()
                y = y[:hi - lo]
            y = back(_round_rows(y, x, xw))
            del xw
        for r in local_rows(spec, idle):
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
    to it (as the reference's weakly typed scalars are); an integer payload
    is promoted to float32, as the reference's float weights promote it."""
    dt = xw.dtype if xw.dtype.is_floating_point else torch.float32
    a, b = (torch.tensor(v, dtype=dt, device=xw.device)
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
    if spec is not None and spec.sharded:
        raise NotImplementedError(
            "mix_pairwise takes an unsharded panel: on a mesh the segment "
            "mixes a matching as its dense W (mix_dense)")
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
    switches the return to ``(mixed, new_err)``. On a sharded spec the
    panel is this rank's shard (``merge_panel`` takes it)."""
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


def _stat_view(x):
    """The panel the ``panel_mean_consensus`` kernel reads: float32,
    bfloat16 and float16 groups as they are (the kernel widens them), any
    other dtype (int32) as float32."""
    if x.dtype in (torch.float32, torch.bfloat16, torch.float16):
        return x
    return x.to(torch.float32)


def merged(panel, live=None, spec: Optional[PanelSpec] = None):
    """The (counterfactual) averaged model as {dtype: (D_dtype,)} f32.

    On a sharded ``spec`` the panel is this rank's shard and the result its
    column shard of the mean: the ``rows`` line's rows gathered and reduced
    by the kernel, bit for bit the single-process columns.

    ``live`` ((m,) bool) restricts the mean to the live rows (the merge of
    an elastic run, where a dead agent's stale row must not enter it): the
    live rows are gathered into a sub-panel and reduced by the unmasked
    ``panel_mean_consensus`` kernel, so the result is the sub-panel's mean
    (the reference takes the live-weighted sum; the two agree to float32
    rounding). No live row gives zeros. On a sharded spec the live rows of
    each gathered column slab."""
    if spec is not None and spec.sharded:
        rows = (None if live is None else
                np.flatnonzero(_live_mask(live, spec.rows)))
        return {k: (_col_mean(x, spec, k, rows) if rows is None or len(rows)
                    else torch.zeros(x.shape[1], dtype=torch.float32,
                                     device=x.device))
                for k, x in panel.items()}
    if live is None:
        return {k: panel_mean_consensus(_stat_view(x))[0]
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
        out[k] = panel_mean_consensus(_stat_view(sub))[0]
        del sub
    return out


def merged_tree(panel, spec: PanelSpec, live=None):
    """The averaged model as a (non-stacked) tree with float32 leaves: the
    panel counterpart of ``gossip.merged_model`` (``live`` as in
    :func:`merged`); on a sharded spec every rank gets the whole model (the
    column shards gathered)."""
    row = merged(panel, live=live, spec=spec)
    if spec.sharded:
        row = {k: gather_cols(v, spec, k) for k, v in row.items()}
    return from_panel(row, spec, cast=False)


def consensus_distance(panel, live=None, spec: Optional[PanelSpec] = None):
    """Xi_t = sqrt((1/m) sum_k ||theta_k - bar||^2), a float32 scalar.

    On a sharded ``spec``: the kernel on the gathered rows of the rank's
    column shard, then one sum of the squared deviations over the ``fsdp``
    line (another order of summation than one process's).

    ``live`` ((m,) bool) takes the consensus of the live rows only: their
    mean, their deviations, over the live count. That mean and the sum of
    squares are taken in float64 a row at a time (no (m, D) temporary), so
    identical live rows read exactly 0 whatever the live count (a float32
    mean of 7 equal rows need not equal the row).

    On a sharded spec every row of the rank's column shard is gathered, a
    slab at a time (the live rows' float64 pass the same way), and the
    column shards' sums are summed over the ``fsdp`` line in float64."""
    x0 = next(iter(panel.values()))
    m = x0.shape[0] if spec is None or not spec.sharded else spec.rows
    if spec is not None and spec.sharded:
        rows = (None if live is None else
                np.flatnonzero(_live_mask(live, m)))
        parts = {}
        for k, x in panel.items():
            part = torch.zeros((), dtype=torch.float64, device=x.device)
            if rows is None:
                for _, _, full in row_slabs(x, spec, k):
                    part += panel_mean_consensus(_stat_view(full))[1]
                    del full
            elif len(rows):
                for _, _, full in row_slabs(x, spec, k):
                    part += _live_sq(full, rows)
                    del full
            parts[k] = part
        total = _reduce_groups(parts, spec, rows=False)
        n = m if rows is None else max(len(rows), 1)
        return torch.sqrt(total / n).to(torch.float32)
    if live is not None:
        rows = np.flatnonzero(_live_mask(live, m))
        total = torch.zeros((), dtype=torch.float64, device=x0.device)
        for x in panel.values() if len(rows) else ():
            total = total + _live_sq(x, rows)
        return torch.sqrt(total / max(len(rows), 1)).to(torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=x0.device)
    for x in panel.values():
        total = total + panel_mean_consensus(_stat_view(x))[1]
    return torch.sqrt(total / m)


def _live_sq(x, rows):
    """The float64 sum over the ``rows`` of x of the squared deviations
    from their float64 column mean (a row at a time: no (m, D) temporary)."""
    mean = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for r in rows:
        mean += x[r]
    mean /= len(rows)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for r in rows:
        total = total + torch.sum(torch.square(x[r].double() - mean))
    return total


def consensus_from_mean(panel, means, spec: Optional[PanelSpec] = None):
    """Xi_t from a PRECOMPUTED column-mean panel ({group: (D_g,) f32},
    e.g. the folded row of :func:`mix_dense_mean`): one deviation pass,
    taken a row at a time so no (m, D) temporary is made. On a sharded
    ``spec`` the panel and the means are this rank's shards: each group's
    partial sum is summed over the ranks holding its other rows and
    columns."""
    x0 = next(iter(panel.values()))
    if spec is not None and spec.sharded:
        parts = {}
        for k, x in panel.items():
            part = torch.zeros((), dtype=torch.float32, device=x0.device)
            for r in range(x.shape[0]):
                part = part + torch.sum(torch.square(
                    x[r].to(torch.float32) - means[k]))
            parts[k] = part
        return torch.sqrt(_reduce_groups(parts, spec) / spec.rows)
    m = x0.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=x0.device)
    for k, x in panel.items():
        for r in range(m):
            total = total + torch.sum(torch.square(
                x[r].to(torch.float32) - means[k]))
    return torch.sqrt(total / m)


def panel_norm(panel, axis_mean: bool = False, rows=None,
               spec: Optional[PanelSpec] = None):
    """Global l2 norm of the panel (f32). With ``axis_mean`` the rows are
    averaged first (norm of the agent-mean, e.g. for grad-norm metrics);
    ``rows`` ((m,) float32 convex weights, e.g. :func:`_live_weights` of a
    live mask) replaces the uniform mean by the weighted one: the grad norm
    of an elastic round averages the live agents only.

    On a sharded ``spec`` the panel is this rank's shard: the agent mean
    is the column sums (``rows``: the weighted sums of the rank's rows)
    summed over the ``rows`` line over m, and each group's sum of squares
    is summed over the ranks of its other parts (another order of
    summation than one process's)."""
    if spec is not None and spec.sharded:
        parts = {}
        for k, x in panel.items():
            x32 = x.to(torch.float32)
            if axis_mean and rows is None:
                x32 = sum_rows(torch.sum(x32, dim=0), spec, k) / spec.rows
            elif axis_mean:
                lo, hi = spec.row_range(k)
                x32 = sum_rows(torch.matmul(rows[lo:hi].to(x32.device), x32),
                               spec, k)
            parts[k] = torch.sum(torch.square(x32))
        return torch.sqrt(_reduce_groups(parts, spec, rows=not axis_mean))
    x0 = next(iter(panel.values()))
    total = torch.zeros((), dtype=torch.float32, device=x0.device)
    for x in panel.values():
        x32 = x.to(torch.float32)
        if axis_mean:
            x32 = (torch.mean(x32, dim=0) if rows is None else
                   torch.matmul(rows.to(x32.device), x32))
        total = total + torch.sum(torch.square(x32))
    return torch.sqrt(total)


# ------------------------------------------------- blocks of state leaves
#
# A state leaf of a sharded run is held in blocks: each rank holds the
# rectangle of rows and columns (``Block.index``) that its layout gives it
# (``core.dsgd.panel_state_layout``). A checkpoint saves each block once
# (``Block.owner``: the one holder among its replicas), and a restore cuts
# the blocks of another layout (another mesh, or one process) out of the
# saved ones, or out of a whole leaf: ``cut_into`` copies the overlap of a
# piece into a target block, which is whole once the pieces cover it
# (``checkpoint.io.restore_latest``).


@dataclass(frozen=True)
class Block:
    """A rank's part of one state leaf whose whole shape is ``shape``:
    [lo, hi) along each dim (``index``); ``owner`` is whether this rank is
    the one of the block's holders that saves it."""
    shape: Tuple[int, ...]
    index: Tuple[Tuple[int, int], ...]
    owner: bool = True

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.index)

    @property
    def size(self) -> int:
        return int(np.prod(self.local_shape, dtype=np.int64))


def whole_block(shape, owner: bool = True) -> Block:
    """The whole leaf of ``shape`` as one block."""
    shape = tuple(int(s) for s in shape)
    return Block(shape=shape, index=tuple((0, s) for s in shape),
                 owner=owner)


def overlap(a, b):
    """The intersection of two indexes ([lo, hi) a dim), or None when it is
    empty."""
    out = tuple((max(p, q), min(r, s)) for (p, r), (q, s) in zip(a, b))
    return None if any(lo >= hi for lo, hi in out) else out


def _local(index, origin):
    return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in
                 zip(index, origin))


def cut_into(dst, dst_index, piece, piece_index) -> int:
    """Copy the overlap of ``piece`` (a tensor or numpy array holding
    ``piece_index`` of a leaf) into ``dst`` (a tensor or numpy array
    holding ``dst_index`` of the same leaf), in place; returns the number
    of elements copied. A bfloat16 tensor takes its int16 bits."""
    ov = overlap(dst_index, piece_index)
    if ov is None:
        return 0
    src = piece[_local(ov, piece_index)]
    if isinstance(dst, np.ndarray):
        dst[_local(ov, dst_index)] = src.numpy() if torch.is_tensor(src) \
            else src
    else:
        if not torch.is_tensor(src):
            src = torch.from_numpy(np.ascontiguousarray(src))
        part = dst[_local(ov, dst_index)]
        if src.dtype != part.dtype:
            src = src.view(part.dtype)
        part.copy_(src)
    return int(np.prod([hi - lo for lo, hi in ov], dtype=np.int64))
