"""Merge operators: how ONE global merging combines the agents (counterpart
of ``repro/merging/ops.py``).

The paper's single global merging is the uniform column mean of the
panel. The other operators of the reference's registry weigh, trim or
smooth the agents before the merge; every one consumes the per-dtype
``{group: (m, D_g)}`` parameter panel (plus, for the statistical
operators, per-agent statistics panels carried in the segment state) and
produces ONE merged row ``{group: (D_g,) f32}``:

* ``uniform``  — the per-group column mean (``panel.merged``).
* ``weighted`` — per-AGENT convex weights: explicit ``weights=`` or, by
  default, the inverse squared distance of each agent to the mean; the
  row is sum_k w_k theta_k through the ``gossip_mix`` kernel at n = 1.
* ``var``      — per-COORDINATE inverse-variance weights from EMA mean and
  second-moment panels of each agent's trajectory over rounds, through the
  ``weighted_colmerge`` kernel.
* ``fisher``   — diagonal-Fisher weights (an EMA of the squared gradients
  of the local steps), through ``weighted_colmerge``.
* ``ties``     — TIES on deviations from the mean: per-row magnitude trim
  (thresholds outside the kernel, ``ref.ties_thresh_ref``), per-column sign
  election and the agreeing mean, through the ``ties_colmerge`` kernel.
* ``swa``      — the uniform mean of per-agent EMA accumulators of the
  parameters over rounds; it never reads the parameter panel.

Statistics contract: an operator with ``stat_panels`` names its per-agent
(m, D_g) float32 panels; the engine keeps them as
``state["merge_stat"][name]``, built by :meth:`Merger.init_stats` and
updated by :meth:`Merger.update_local` (every local step, from the gradient
panel) and :meth:`Merger.update_round` (once per round, from the parameter
panel). The updates run IN PLACE, one row at a time: each product of the
EMA goes into a (D,) temporary and the sum is rounded once, as the
reference's ``b * s + (1 - b) * x`` rounds each product on its own.

Statistics held in a residency storage (``--residency stats=...``) are
decoded by :func:`decode_stats` before an operator reads them; every merge
entry point goes through it.

Sharded panels (``panel.shard_spec``): ``merge_row(..., spec=)`` and
:func:`merge_panel` take a rank's shard of the panel and of the statistics
and give the rank's column shard of the merged row, the single-process
columns bit for bit: the per-column operators (uniform, var, fisher, swa,
TIES's election and agreeing mean) run on every agent's rows of a column
slab at a time (gathered over the ``rows`` line), TIES's per-row trim
thresholds come from an exact distributed selection
(:func:`ties_thresh_sharded`: a radix select on the float32 bit patterns
of |tau|, its 256-bin histograms summed over ``fsdp``), and ``weighted``'s
per-agent squared distances are the column shards' partial sums summed
over ``fsdp`` (another order of summation: within float32 tolerance).

Liveness: ``live=`` ((m,) bool) restricts every operator to the live
agents' rows, exactly as if it ran on the live sub-panel: the live mean
(uniform, swa), weight 0 for a dead agent (weighted), the weight panel
times the live column so that ``weighted_colmerge`` leaves dead rows out of
both of its sums (var, fisher), and the live mean as the reference row with
dead agents' deviation rows zeroed, which TIES's trim, election and
agreeing mean ignore (ties).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import panel as panel_mod
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.kernels.merge_ops import ties_colmerge, weighted_colmerge
from repro_torch.kernels.ref import _fma32, ties_index, ties_thresh_ref


def _ema_(stat, x, b: float, square: bool = False):
    """stat <- b * stat + (1 - b) * x (x squared first with ``square``), in
    place, one row at a time; each product rounded on its own."""
    for r in range(stat.shape[0]):
        xr = x[r].to(torch.float32)
        xr = torch.square(xr) if square else xr
        torch.add(stat[r] * b, xr * (1.0 - b), out=stat[r])


def _live_col(live, x, rows=None):
    """The (m, 1) float32 live column of a live mask, on x's device;
    ``rows``: the (lo, hi) agents of x, a row shard of the m rows."""
    if rows is None:
        mask = panel_mod._live_mask(live, x.shape[0])
    else:
        mask = panel_mod._live_mask(live, len(live))[rows[0]:rows[1]]
    return torch.as_tensor(mask, dtype=torch.float32,
                           device=x.device)[:, None]


def _sharded(spec) -> bool:
    return spec is not None and spec.sharded


def _colwise(spec, k, fn, *panels):
    """The rank's (c,) column shard of ``fn(*gathered)``, a per-column
    function of every agent's rows of a column slab of each of the rank's
    shards ``panels`` of group ``k`` (gathered over the ``rows`` line), a
    slab at a time."""
    x0 = panels[0]
    out = torch.empty(x0.shape[1], dtype=torch.float32, device=x0.device)
    for slabs in zip(*(panel_mod.row_slabs(p, spec, k) for p in panels)):
        lo, hi, _ = slabs[0]
        out[lo:hi] = fn(*(g for _, _, g in slabs))
        del slabs
    return out


def _need_stats(name, stats, what):
    if stats is None:
        raise ValueError(
            f"merger '{name}' needs its {what} (stats=...); build them "
            f"with init_stats / init_panel_state(merger='{name}')")


class Merger:
    """Base merge operator: the uniform column mean.

    Subclasses override :meth:`merge_row` and, for statistical operators,
    declare ``stat_panels`` and the update hooks."""

    name = "uniform"
    stat_panels: tuple = ()   # names of per-agent (m, D_g) f32 stat panels
    local_stat = False        # update_local runs every local step (grads)
    round_stat = False        # update_round runs once per round (params)
    uses_panel = True         # merge_row reads the (wire-encoded) params

    def init_stats(self, panel):
        """{stat_name: {group: (m, D_g) f32}} from the initial panel."""
        return {}

    def update_local(self, stats, gpan):
        """Fold one local step's gradient panel into the stats (in place)."""
        return stats

    def update_round(self, stats, panel):
        """Fold one round's post-local-steps parameter panel into the stats
        (in place)."""
        return stats

    def merge_row(self, panel, stats=None, weights=None, live=None,
                  spec=None):
        """One merged row {group: (D_g,) f32} from the (m, D) panel; with
        ``live`` ((m,) bool) from the live rows alone. On a sharded
        ``spec`` the panel and the stats are this rank's shards and the
        row its column shard."""
        return panel_mod.merged(panel, live=live, spec=spec)


class UniformMerger(Merger):
    """The paper's single global merging: the per-group column mean."""


class WeightedMerger(Merger):
    """Per-agent convex weights: explicit ``weights=`` (m,), or inverse
    squared consensus distance by default (w_k proportional to
    1 / (||theta_k - mean||^2 + eps) over all groups; identical rows give
    the uniform mean)."""

    name = "weighted"

    def __init__(self, eps: float = 1e-8):
        self.eps = eps

    def agent_weights(self, panel, live=None, spec=None):
        """(m,) convex weights; with ``live`` the distances are taken to the
        live mean and a dead agent's weight is 0. On a sharded ``spec``
        each agent's squared distance is its column shards' partial sums
        summed over ``fsdp``, gathered over the ``rows`` line."""
        d = None
        for k, x in panel.items():
            x32 = x.to(torch.float32)
            mu = panel_mod.merged({k: x32}, live=live, spec=spec)[k]
            dk = torch.stack([torch.sum(torch.square(x32[r] - mu))
                              for r in range(x32.shape[0])])
            if _sharded(spec):
                dk = panel_mod.gather_rows(spec.shard(k).col_sum(dk), spec, k)
            d = dk if d is None else d + dk
        w = torch.reciprocal(d + self.eps)
        if live is not None:
            w = w * _live_col(live, w)[:, 0]
        return w / torch.sum(w)

    def merge_row(self, panel, stats=None, weights=None, live=None,
                  spec=None):
        x0 = next(iter(panel.values()))
        if weights is None:
            w = self.agent_weights(panel, live=live, spec=spec)
        else:
            w = torch.as_tensor(weights, dtype=torch.float32,
                                device=x0.device)
            if live is not None:
                w = w * _live_col(live, w)[:, 0]
            w = w / torch.sum(w)
        W = w[None].contiguous()
        if _sharded(spec):
            return {k: _colwise(spec, k, lambda g: gossip_mix(W, g)[0], x)
                    for k, x in panel.items()}
        return {k: gossip_mix(W, x)[0] for k, x in panel.items()}


class VarMerger(Merger):
    """Per-coordinate inverse-variance weighting: EMA mean and second-moment
    panels of each agent's parameter trajectory over rounds
    (``update_round``); the merge weights are 1 / (Var + eps). Fresh stats
    (zero variance everywhere) give the uniform mean."""

    name = "var"
    stat_panels = ("traj_mu", "traj_m2")
    round_stat = True

    def __init__(self, ema: float = 0.9, eps: float = 1e-8):
        self.ema = ema
        self.eps = eps

    def init_stats(self, panel):
        mu = {k: x.to(torch.float32, copy=True) for k, x in panel.items()}
        return {"traj_mu": mu,
                "traj_m2": {k: torch.square(v) for k, v in mu.items()}}

    def update_round(self, stats, panel):
        for k, x in panel.items():
            _ema_(stats["traj_mu"][k], x, self.ema)
            _ema_(stats["traj_m2"][k], x, self.ema, square=True)
        return stats

    def weight_panel(self, stats, k):
        """The (m, D_g) weights 1 / (max(m2 - mu^2, 0) + eps) of group k,
        built in place a row at a time (one panel, no other temporary)."""
        mu, m2 = stats["traj_mu"][k], stats["traj_m2"][k]
        w = torch.empty_like(mu)
        for r in range(w.shape[0]):
            torch.square(mu[r], out=w[r])
            torch.sub(m2[r], w[r], out=w[r])
            w[r].clamp_min_(0.0).add_(self.eps).reciprocal_()
        return w

    def merge_row(self, panel, stats=None, weights=None, live=None,
                  spec=None):
        _need_stats(self.name, stats, "trajectory stats panels")
        if _sharded(spec):
            def one(k):
                def fn(x, mu, m2):
                    w = self.weight_panel({"traj_mu": {k: mu},
                                           "traj_m2": {k: m2}}, k)
                    if live is not None:
                        w.mul_(_live_col(live, w))
                    return weighted_colmerge(x.to(torch.float32), w)
                return fn
            return {k: _colwise(spec, k, one(k), x, stats["traj_mu"][k],
                                stats["traj_m2"][k])
                    for k, x in panel.items()}
        out = {}
        for k, x in panel.items():
            w = self.weight_panel(stats, k)
            if live is not None:
                # the column merge divides by the per-column weight sum, so
                # a zero row is out of both sums
                w.mul_(_live_col(live, w))
            out[k] = weighted_colmerge(x.to(torch.float32), w)
        return out


class FisherMerger(Merger):
    """Diagonal-Fisher weighted merge: each agent keeps an EMA of its
    squared gradients over the local steps (F ~ E[g^2]); the merge is the
    column mean weighted by F + eps. Fresh stats (F = 0) give the uniform
    mean."""

    name = "fisher"
    stat_panels = ("fisher",)
    local_stat = True

    def __init__(self, ema: float = 0.9, eps: float = 1e-8):
        self.ema = ema
        self.eps = eps

    def init_stats(self, panel):
        return {"fisher": {k: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device)
                           for k, x in panel.items()}}

    def update_local(self, stats, gpan):
        for k, g in gpan.items():
            _ema_(stats["fisher"][k], g, self.ema, square=True)
        return stats

    def merge_row(self, panel, stats=None, weights=None, live=None,
                  spec=None):
        _need_stats(self.name, stats, "Fisher stats panel")
        if _sharded(spec):
            def fn(x, f):
                w = f + self.eps
                if live is not None:
                    w.mul_(_live_col(live, w))
                return weighted_colmerge(x.to(torch.float32), w)
            return {k: _colwise(spec, k, fn, x, stats["fisher"][k])
                    for k, x in panel.items()}
        out = {}
        for k, x in panel.items():
            w = stats["fisher"][k] + self.eps
            if live is not None:
                w.mul_(_live_col(live, w))
            out[k] = weighted_colmerge(x.to(torch.float32), w)
        return out


class TiesMerger(Merger):
    """TIES on deviations from the mean: per-row top-``trim`` magnitude
    trim, per-column sign election over the survivors, and the agreeing
    mean of the elected deviations added back to the mean row.
    ``trim=1.0`` keeps every deviation: the pure sign-elected mean."""

    name = "ties"

    def __init__(self, trim: float = 0.2):
        if not 0.0 < trim <= 1.0:
            raise ValueError(f"trim fraction must be in (0, 1], got {trim}")
        self.trim = trim

    def merge_row(self, panel, stats=None, weights=None, live=None,
                  spec=None):
        if _sharded(spec):
            return {k: self._merge_sharded(k, x, live, spec)
                    for k, x in panel.items()}
        out = {}
        for k, x in panel.items():
            x32 = x.to(torch.float32)
            ref_row = panel_mod.merged({k: x32}, live=live)[k]
            tau = x32 - ref_row
            del x32
            if live is not None:
                # a zero deviation row is inert through the trim, the sign
                # election and the agreeing mean: the live sub-panel's TIES
                tau.mul_(_live_col(live, tau))
            dev = ties_colmerge(tau, ties_thresh_ref(tau, self.trim))
            del tau
            out[k] = dev.add_(ref_row)
        return out

    def _merge_sharded(self, k, x, live, spec):
        """merge_row of group ``k`` on this rank's shard ``x``: the
        deviations of the rank's rows are formed a column slab at a time
        from the (live) mean row, each row's trim threshold comes from
        :func:`ties_thresh_sharded` over its column shards, and the column
        merge runs on every agent's deviations of a slab (gathered)."""
        x32 = x.to(torch.float32)
        ref_row = panel_mod.merged({k: x32}, live=live, spec=spec)[k]
        lcol = None if live is None else _live_col(live, x32,
                                                   spec.row_range(k))

        def tau(lo, hi):
            t = x32[:, lo:hi] - ref_row[lo:hi]
            return t if lcol is None else t.mul_(lcol)

        c = x32.shape[1]
        th = panel_mod.gather_rows(ties_thresh_sharded(
            tau, x32.shape[0], c, self.trim, spec.shard(k)), spec, k)
        out = torch.empty(c, dtype=torch.float32, device=x.device)
        for lo in range(0, c, panel_mod.GATHER_SLAB):
            hi = min(lo + panel_mod.GATHER_SLAB, c)
            full = panel_mod.gather_rows(tau(lo, hi), spec, k)
            out[lo:hi] = ties_colmerge(full, th).add_(ref_row[lo:hi])
            del full
        return out


class SwaMerger(Merger):
    """Merge of per-agent SWA/EMA accumulators: each agent keeps an EMA of
    its parameters over the ROUNDS (a <- d a + (1 - d) theta after each
    round, from theta_0); the merged row is the uniform mean of the
    accumulators. The parameter panel itself never travels."""

    name = "swa"
    stat_panels = ("swa",)
    round_stat = True
    uses_panel = False

    def __init__(self, decay: float = 0.9):
        self.decay = decay

    def init_stats(self, panel):
        return {"swa": {k: x.to(torch.float32, copy=True)
                        for k, x in panel.items()}}

    def update_round(self, stats, panel):
        for k, x in panel.items():
            _ema_(stats["swa"][k], x, self.decay)
        return stats

    def merge_row(self, panel, stats=None, weights=None, live=None,
                  spec=None):
        _need_stats(self.name, stats, "accumulator stats panel")
        return panel_mod.merged(stats["swa"], live=live, spec=spec)


# columns of |tau| a pass of the distributed TIES selection reads at once
TIES_SLAB = 1 << 20
_RADIX_SHIFTS = (24, 16, 8, 0)


def ties_thresh_sharded(tau, rows: int, width: int, trim: float, shard):
    """``ref.ties_thresh_ref`` of whole rows held as column shards: the
    (rows, 1) float32 thresholds of this rank's ``rows`` deviation rows,
    bit for bit the single-process ones.

    ``tau(lo, hi)`` gives the rank's (rows, hi - lo) deviations of its
    column shard's columns [lo, hi) (``width`` of them); ``shard`` is the
    group's ``panel.Shard`` (the whole rows' width ``shard.D``, the sums
    over ``fsdp``; None: the rows are whole). The two order statistics of
    each row's |tau| are selected exactly by a radix select on the float32
    bit patterns (the patterns of non-negative floats order as their
    values): four passes of 8 bits, each a 256-bin histogram of the
    entries that match the prefix found so far, read ``TIES_SLAB`` columns
    at a time and summed over the ``fsdp`` line; then the index and
    interpolation arithmetic of ``ties_thresh_ref``. A row holding a NaN
    anywhere gives NaN."""
    D = width if shard is None else shard.D
    lo_i, hi_i, lw, hw = ties_index(D, trim)
    dev = tau(0, 0).device
    want = torch.tensor([lo_i, hi_i], dtype=torch.int64,
                        device=dev).expand(rows, 2).clone()
    prefix = torch.zeros((rows, 2), dtype=torch.int64, device=dev)
    pmask = torch.zeros((rows, 2), dtype=torch.int64, device=dev)
    nans = torch.zeros((rows,), dtype=torch.int64, device=dev)
    base = (torch.arange(rows * 2, dtype=torch.int64, device=dev)
            .view(rows, 2, 1) * 256)
    for shift in _RADIX_SHIFTS:
        hist = torch.zeros(rows * 2 * 256, dtype=torch.int64, device=dev)
        for lo in range(0, width, TIES_SLAB):
            t = tau(lo, min(lo + TIES_SLAB, width))
            if shift == _RADIX_SHIFTS[0]:
                nans += torch.isnan(t).sum(dim=1)
            bits = torch.abs(t).view(torch.int32).to(torch.int64)
            del t
            match = (bits[:, None, :] & pmask[:, :, None]) \
                == prefix[:, :, None]
            idx = base + ((bits >> shift) & 0xFF)[:, None, :]
            hist += torch.bincount(idx[match], minlength=rows * 2 * 256)
            del bits, match, idx
        if shard is not None:
            hist = shard.col_sum(hist)
        cum = torch.cumsum(hist.view(rows, 2, 256), dim=2)
        bucket = torch.sum(cum <= want[:, :, None], dim=2)
        below = torch.gather(cum, 2, (bucket - 1).clamp(min=0)[:, :, None])
        want -= torch.where(bucket > 0, below[:, :, 0], 0)
        prefix |= bucket << shift
        pmask |= 0xFF << shift
    if shard is not None:
        nans = shard.col_sum(nans)
    vals = prefix.to(torch.int32).view(torch.float32).cpu().numpy()
    nan_rows = nans.cpu().numpy() > 0
    out = np.empty((rows, 1), dtype=np.float32)
    for r in range(rows):
        out[r, 0] = (np.nan if nan_rows[r] else
                     _fma32(vals[r, 0], lw, vals[r, 1] * hw))
    return torch.from_numpy(out).to(dev)


MERGERS = {
    "uniform": UniformMerger(),
    "weighted": WeightedMerger(),
    "var": VarMerger(),
    "fisher": FisherMerger(),
    "ties": TiesMerger(),
    "swa": SwaMerger(),
}


def get_merger(name):
    """Resolve a merge operator by registry name; Merger instances pass
    through (e.g. ``TiesMerger(trim=1.0)``)."""
    if isinstance(name, Merger):
        return name
    try:
        return MERGERS[name]
    except KeyError:
        raise ValueError(
            f"unknown merge operator {name!r}; known: {sorted(MERGERS)}"
        ) from None


def decode_stats(stats, spec):
    """Statistics panels held in the spec's ``stats`` residency storage ->
    their float32 view ({stat: {group: (m, D_g) f32}}). ``maybe_read``
    lets already decoded float32 panels pass, so the segment's own decoded
    statistics, and every run without a stats policy, go through
    unchanged."""
    if stats is None or spec is None:
        return stats
    name = spec.residency_of("stats")
    if name == "f32":
        return stats
    from repro_torch import residency as residency_mod
    st = residency_mod.get_storage(name)
    return {sn: {g: st.maybe_read(v) for g, v in grp.items()}
            for sn, grp in stats.items()}


def merge_panel(panel, merger, *, stats=None, weights=None, spec=None,
                gen=None, err=None, live=None, wire_dtype=None):
    """One global merge ROUND: every agent transmits its panel through the
    spec's wire policy (as ``panel.global_merge``: stochastic codecs draw
    from ``gen``, error feedback threads ``err``), the operator folds the
    decoded payloads (and its ``stats``, or the agent ``weights``) into ONE
    merged row, and the row is broadcast back to every agent.

    A delta (mirror) codec cannot sync a one-shot merge with a sparse
    payload, so the global round is its full-bandwidth round: the operator
    sees the exact panel and the mirror resets to the merged state. An
    operator that never reads the parameter panel (``uses_panel`` False:
    swa merges its accumulators) skips the codec entirely: nothing travels
    the parameter wire, so nothing is quantized and the error-feedback
    state passes through untouched.

    ``wire_dtype`` is the reference's legacy payload cast, in place of the
    spec's wire policy (``panel._codecs``).

    ``live`` ((m,) bool) makes the round elastic: only live rows feed the
    operator and receive the broadcast; a dead agent's parameter row and
    its error-feedback (residual or mirror) row pass through bit for bit.

    On a sharded ``spec`` the panel, the stats and ``err`` are this rank's
    shards: each group encodes on its block (``Codec.encode(shard=)``) and
    the operator merges column shards (``merge_row(spec=)``); the returned
    row is the rank's column shard.

    Returns ``(mixed, row, new_err)``: the broadcast (m, D) panel in storage
    dtypes, the merged {group: (D_g,) f32} row, and the updated
    error-feedback state (None when ``err`` is)."""
    merger = get_merger(merger)
    stats = decode_stats(stats, spec)
    sharded = _sharded(spec)
    enc, backs = {}, {}
    if merger.uses_panel:
        codecs = panel_mod._codecs(panel, spec, wire_dtype)
        panel_mod._require_gen(codecs, gen)
        new_err = {} if err is not None else None
        for k in sorted(panel):
            x = panel[k]
            e = err[k] if err is not None else None
            if codecs[k].delta_mix:
                if e is None:
                    raise ValueError(
                        f"codec '{codecs[k].name}' carries a mirror panel "
                        "and needs it (err=...)")
                enc[k] = x.to(torch.float32)
                backs[k] = None
                continue
            enc[k], backs[k], ne = codecs[k].encode(
                x, gen=gen, err=e, shard=spec.shard(k) if sharded else None)
            if err is not None:
                new_err[k] = ne
    else:
        enc = panel
        backs = {k: (lambda y: y) for k in panel}
        new_err = err
    row = merger.merge_row(enc, stats=stats, weights=weights, live=live,
                           spec=spec)
    m = spec.rows if sharded else next(iter(panel.values())).shape[0]
    dead = ([] if live is None else panel_mod.local_rows(
        spec, np.flatnonzero(~panel_mod._live_mask(live, m))))
    mixed = {}
    for k, x in panel.items():
        if backs[k] is None:  # delta codec: panel and mirror take the row
            y32 = row[k][None].expand(x.shape).contiguous()
            mixed[k] = y32.to(x.dtype)
            if new_err is not None:
                new_err[k] = (y32.clone() if x.dtype == torch.float32
                              else y32)
        else:
            mixed[k] = backs[k](row[k][None].expand(x.shape)
                                .to(enc[k].dtype).contiguous())
        # dead agents did not take part: parameters and error-feedback
        # rows as they were (a dead mirror stays pre-merge, so its next
        # delta mix still pulls against it)
        for r in dead:
            mixed[k][r].copy_(x[r])
            if new_err is not None and new_err[k] is not err[k]:
                new_err[k][r].copy_(err[k][r])
    return mixed, row, new_err
