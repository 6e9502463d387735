"""Host-side accounting of the residency policy (counterpart of the
residency part of ``repro/telemetry/metrics.py``): the fused-update
eligibility predicate and the exact byte models of what the state panels
hold and what the moment panels move.
"""
from __future__ import annotations

from repro_torch import merging as merging_mod
from repro_torch import residency as residency_mod
from repro_torch import wire as wire_mod
from repro_torch.wire.codec import _itemsize


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


def resident_bytes_model(spec, optimizer=None, fused=None):
    """Exact per-agent resident bytes of the engine's state panels under
    the spec's residency policy: ``{"params", "moments", "wire_err",
    "merge_stat", "total", "transient_bytes", "peak"}``, scales included.

    Moments count ``optimizer.moment_keys`` panels (AdamW's two when
    ``optimizer`` is None) and mirror each group's dtype; the error-feedback
    panel exists when the wire policy has error feedback; merge statistics
    count the operator's ``stat_panels``. ``total`` is the stored
    footprint; ``transient_bytes`` the float32 decode views the unfused
    path makes inside a round (moments each local step, stats at round
    entry, the residual in communicating rounds), with no moment term when
    the fused kernel runs (``fused=None`` asks :func:`fused_moments_auto`);
    ``peak = total + transient_bytes``."""
    params = sum(_itemsize(k) * w for k, w in spec.groups)
    n_mom = 2 if optimizer is None else len(optimizer.moment_keys)
    moments = n_mom * spec.storage_bytes("moments")
    needs_ef = any(wire_mod.get_codec(spec.wire_of(k)).error_feedback
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
