"""Per-agent metric columns and the byte models (counterpart of
``repro/telemetry/metrics.py``).

The segment driver (``dsgd.make_panel_segment(telemetry=True)``) stacks
the per-round (m,) columns of this module into (S, m) metrics: per-agent
loss, grad norm and distance to the mean, the liveness trit and the wire
bytes each agent paid. Each is a pure read of what the round already
made: telemetry never perturbs the trajectory. The float columns are
tensors on the panel's device, reduced without an (m, D) temporary (a
row-wise norm; float64 column slabs); the integer columns are computed on the
host from W and the trits, as exact int64 (the reference's int32 wraps
above 2 GiB an agent-round). On a sharded spec (``spec=``) the panels are
the rank's shards and every rank gets all m agents' columns: the row
norms' and distances' partial sums over the rank's columns are summed
over the ``fsdp`` line (another order of summation than one process's)
and gathered over the ``rows`` line.

Wire bytes follow the codec cost model (:attr:`PanelSpec.wire_total_bytes`:
payload + scales/indices): a row of W equal to the identity row sends
nothing and pays 0; a delta (mirror) codec's GLOBAL round is its
full-bandwidth round and pays the storage bytes; a RESYNC agent pays the
full-precision pull.

The rest is host-side accounting of the residency policy: the
fused-update eligibility predicate and the exact byte models of what the
state panels hold and what the moment panels move.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import merging as merging_mod
from repro_torch import residency as residency_mod
from repro_torch import wire as wire_mod
from repro_torch.core import panel as panel_mod
from repro_torch.wire.codec import _itemsize


# the per-agent columns of make_panel_segment(telemetry=True), as a round
# event carries them
AGENT_COLUMNS = ("loss_agent", "grad_norm_agent", "dist_to_mean", "live",
                 "wire_bytes")
# columns a slab of agent_dist_to_mean reduces at once (float64 views)
DIST_SLAB = 1 << 21


def _row_mask(alive, device):
    return torch.as_tensor(np.asarray(alive, dtype=bool), device=device)


def agent_loss(losses, alive=None):
    """(m,) per-agent loss as float32; non-live rows report 0 (they took
    no step). ``alive``: an (m,) bool mask (array or tensor) or None."""
    x = losses.to(torch.float32)
    if alive is None:
        return x
    return torch.where(_row_mask(alive, x.device), x, 0.0)


def agent_grad_norm(gpan, alive=None, spec=None):
    """(m,) per-agent gradient l2 norm over every dtype group of a grad
    panel ({group: (m, D_g)}); non-live rows report 0. Each group is
    reduced by one row-wise norm (no (m, D) temporary)."""
    norms = [torch.linalg.vector_norm(x, dim=1, dtype=torch.float32)
             for x in gpan.values()]
    if spec is not None and spec.sharded:
        sq = [panel_mod.gather_rows(spec.shard(k).col_sum(torch.square(n)),
                                    spec, k) for k, n in zip(gpan, norms)]
        gn = torch.sqrt(sum(sq[1:], sq[0]))
    else:
        gn = (norms[0] if len(norms) == 1 else
              torch.sqrt(sum(torch.square(n) for n in norms)))
    if alive is None:
        return gn
    return torch.where(_row_mask(alive, gn.device), gn, 0.0)


def agent_dist_to_mean(panel, live=None, spec=None):
    """(m,) float32 per-agent distance to the panel mean, the consensus
    decomposition: the consensus distance is ``sqrt(mean(dist**2))`` of
    these rows (over the live rows under a liveness mask). Non-live rows
    still report their distance to the LIVE mean: how far a stale agent
    has drifted is the straggler signal the column exists for.

    The mean and the squares are taken in float64, a slab of DIST_SLAB
    columns at a time (no (m, D) temporary), so identical rows read exactly
    0 whatever the count; no live row gives a mean of 0. On a sharded
    ``spec`` every agent's rows of a slab of the rank's columns are
    gathered, and each group's totals summed over ``fsdp``."""
    x0 = next(iter(panel.values()))
    sharded = spec is not None and spec.sharded
    m, dev = (spec.rows if sharded else x0.shape[0]), x0.device
    rows = None
    if live is not None:
        rows = torch.as_tensor(np.flatnonzero(np.asarray(live, dtype=bool)
                                              .reshape(m)), device=dev)
    n = m if rows is None else len(rows)
    total = torch.zeros((m,), dtype=torch.float64, device=dev)
    for k, x in panel.items():
        # one process sums every slab into the total, a shard its group's
        part = (torch.zeros((m,), dtype=torch.float64, device=dev)
                if sharded else total)
        slabs = (panel_mod.row_slabs(x, spec, k, DIST_SLAB) if sharded else
                 ((lo, None, x[:, lo:lo + DIST_SLAB])
                  for lo in range(0, x.shape[1], DIST_SLAB)))
        for _, _, xk in slabs:
            xs = xk.to(torch.float64, copy=True)
            del xk
            sub = xs if rows is None else xs[rows]
            mean = torch.sum(sub, dim=0) / max(n, 1)
            del sub
            xs.sub_(mean)
            part += torch.sum(xs.square_(), dim=1)
            del xs, mean
        if sharded:
            total += spec.shard(k).col_sum(part)
    return torch.sqrt(total).to(torch.float32)


def wire_bytes_model(spec, wire_dtype=None):
    """Host-side (bytes_wire, bytes_full) per agent per full-panel
    exchange: the codec-aware wire cost (``spec.wire_total_bytes``, or the
    legacy ``wire_dtype`` cast's itemsize model) and the full-precision
    storage cost (what a delta codec's global round or a RESYNC pull
    moves)."""
    bytes_full = sum(_itemsize(k) * w for k, w in spec.groups)
    if wire_dtype is not None:
        it = _itemsize(wire_dtype)
        return sum(it * w for _, w in spec.groups), bytes_full
    return spec.wire_total_bytes, bytes_full


def round_wire_bytes(W, *, bytes_wire: int, bytes_full: int,
                     full_bandwidth=None, lv=None):
    """(m,) int64 wire bytes each agent paid this round (host numpy).

    Identity rows of W (idle agents, unmatched partners, the degraded rows
    of dead agents) pay 0: nothing travels their wire, the engine's
    per-row idle rule. ``full_bandwidth`` (a bool; a delta codec's global
    round) switches communicating rows to the full-precision cost; ``lv``
    (the (m,) liveness trits) zeroes DEAD rows and charges RESYNC rows the
    full-precision pull."""
    W = panel_mod.host_array(W, np.float32)
    m = W.shape[0]
    idle = np.all(W == np.eye(m, dtype=np.float32), axis=1)
    per = np.where(idle, 0, int(bytes_wire)).astype(np.int64)
    if full_bandwidth is not None and bool(full_bandwidth):
        per = np.where(idle, per, int(bytes_full))
    if lv is not None:
        lv = panel_mod.host_array(lv, np.int64).reshape(m)
        per = np.where(lv == 0, 0, per)
        per = np.where(lv == 2, int(bytes_full), per)
    return per.astype(np.int64)


def live_trits(lv, m: int):
    """(m,) int64 liveness column (all LIVE when the round carries no
    mask)."""
    if lv is None:
        return np.ones((m,), np.int64)
    return panel_mod.host_array(lv, np.int64).reshape(m)


def fused_moments_auto(spec, optimizer) -> bool:
    """Whether the fused int8 moment update (kernels/opt_fused.py) applies
    to this spec and optimizer — the one predicate the segment driver, the
    byte models and the launcher consult. True iff the moments' storage
    supports ``fused_update`` (grouped int8) and rounds stochastically, the
    optimizer exposes ``core``, ``hyper`` and the constants ``hparams``
    with the (m, v) moments the kernel assumes, and the spec has a float32
    group for the policy to act on."""
    if optimizer is None or optimizer.core is None \
            or optimizer.hyper is None or optimizer.hparams is None:
        return False
    if tuple(optimizer.moment_keys) != ("m", "v"):
        return False
    st = residency_mod.get_storage(spec.residency_of("moments"))
    if not (getattr(st, "fused_update", False) and st.needs_key):
        return False
    return any(g == "float32" for g, _ in spec.groups)


def resident_bytes_model(spec, optimizer=None, wire_dtype=None, fused=None):
    """Exact per-agent resident bytes of the engine's state panels under
    the spec's residency policy: ``{"params", "moments", "wire_err",
    "merge_stat", "total", "transient_bytes", "peak"}``, scales included.

    Moments count ``optimizer.moment_keys`` panels (AdamW's two when
    ``optimizer`` is None) and mirror each group's dtype; the error-feedback
    panel exists when the wire policy has error feedback (the legacy
    ``wire_dtype`` cast has none, so it zeroes it); merge statistics
    count the operator's ``stat_panels``. ``total`` is the stored
    footprint; ``transient_bytes`` the float32 decode views the unfused
    path makes inside a round (moments each local step, stats at round
    entry, the residual in communicating rounds), with no moment term when
    the fused kernel runs (``fused=None`` asks :func:`fused_moments_auto`);
    ``peak = total + transient_bytes``."""
    params = sum(_itemsize(k) * w for k, w in spec.groups)
    n_mom = 2 if optimizer is None else len(optimizer.moment_keys)
    moments = n_mom * spec.storage_bytes("moments")
    needs_ef = wire_dtype is None and any(
        wire_mod.get_codec(spec.wire_of(k)).error_feedback
        for k, _ in spec.groups)
    wire_err = (spec.storage_bytes("wire_err", state_dtype="float32")
                if needs_ef else 0)
    merger = merging_mod.get_merger(spec.merger)
    merge_stat = (len(merger.stat_panels)
                  * spec.storage_bytes("stats", state_dtype="float32"))
    out = {"params": params, "moments": moments, "wire_err": wire_err,
           "merge_stat": merge_stat}
    out["total"] = sum(out.values())
    if fused is None:
        fused = fused_moments_auto(spec, optimizer)
    f32_w = sum(w for g, w in spec.groups if g == "float32")
    all_w = sum(w for _, w in spec.groups)

    def stored(kind):
        return residency_mod.get_storage(spec.residency_of(kind)).name \
            != "f32"

    transient = 0
    if not fused and stored("moments"):
        transient += n_mom * 4 * f32_w
    if needs_ef and stored("wire_err"):
        transient += 4 * all_w
    if merger.stat_panels and stored("stats"):
        transient += len(merger.stat_panels) * 4 * all_w
    out["transient_bytes"] = transient
    out["peak"] = out["total"] + transient
    return out


def moment_traffic_model(spec, optimizer=None, local_steps: int = 1,
                         fused=None):
    """Per-agent bytes MOVED per round by the optimizer moment panels.

    Every local step each moment panel pays a read and a write of its
    stored form (both paths); the unfused path also round-trips a float32
    view per stored panel (decode write, update read and write, encode
    read: 16 bytes a value). The uniforms cost the same in both paths and
    are not counted. Returns ``{"stored_bytes_per_step",
    "transient_bytes_per_step", "bytes_per_step", "bytes_per_round"}``."""
    n_mom = 2 if optimizer is None else len(optimizer.moment_keys)
    st = residency_mod.get_storage(spec.residency_of("moments"))
    if fused is None:
        fused = fused_moments_auto(spec, optimizer)
    stored = transient = 0
    for g, w in spec.groups:
        if g == "float32":
            stored += 2 * st.resident_bytes(1, w)
            if st.name != "f32" and not fused:
                transient += 16 * w
        else:
            stored += 2 * _itemsize(g) * w
    per_step = n_mom * (stored + transient)
    return {"stored_bytes_per_step": n_mom * stored,
            "transient_bytes_per_step": n_mom * transient,
            "bytes_per_step": per_step,
            "bytes_per_round": per_step * local_steps}
