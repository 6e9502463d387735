"""Merge operators, main-path subset (counterpart of ``repro/merging/ops.py``).

The paper's single global merging is the uniform column mean of the panel;
the statistical operators (weighted, var, fisher, ties, swa) arrive with
their slice. :func:`merge_panel` runs one global merge ROUND through an
operator and the spec's wire policy.
"""
from __future__ import annotations

import torch

from repro_torch.core import panel as panel_mod


class Merger:
    """A merge operator: one merged row {group: (D_g,) f32} from a panel."""

    name = "base"

    def merge_row(self, panel):
        return panel_mod.merged(panel)


class UniformMerger(Merger):
    """The paper's single global merging: the per-group column mean."""

    name = "uniform"


MERGERS = {"uniform": UniformMerger()}


def get_merger(name):
    """Resolve a merge operator by registry name; Merger instances pass
    through."""
    if isinstance(name, Merger):
        return name
    try:
        return MERGERS[name]
    except KeyError:
        raise ValueError(
            f"unknown merge operator {name!r}; the port has "
            f"{sorted(MERGERS)}") from None


def merge_panel(panel, merger, *, spec=None, gen=None, err=None):
    """One global merge ROUND: every agent transmits its panel through the
    spec's wire policy (as ``panel.global_merge``: stochastic codecs draw
    from ``gen``, error feedback threads ``err``), the operator folds the
    decoded payloads into ONE merged row, and the row is broadcast back to
    every agent.

    A delta (mirror) codec cannot sync a one-shot merge with a sparse
    payload, so the global round is its full-bandwidth round: the operator
    sees the exact panel and the mirror resets to the merged state.

    Returns ``(mixed, row, new_err)``: the broadcast (m, D) panel in storage
    dtypes, the merged {group: (D_g,) f32} row, and the updated
    error-feedback state (None when ``err`` is)."""
    merger = get_merger(merger)
    codecs = panel_mod._codecs(panel, spec)
    panel_mod._require_gen(codecs, gen)
    enc, backs = {}, {}
    new_err = {} if err is not None else None
    for k in sorted(panel):
        x = panel[k]
        e = err[k] if err is not None else None
        if codecs[k].delta_mix:
            if e is None:
                raise ValueError(
                    f"codec '{codecs[k].name}' carries a mirror panel and "
                    "needs it (err=...)")
            enc[k] = x.to(torch.float32)
            backs[k] = None
            continue
        enc[k], backs[k], ne = codecs[k].encode(x, gen=gen, err=e)
        if err is not None:
            new_err[k] = ne
    row = merger.merge_row(enc)
    mixed = {}
    for k, x in panel.items():
        if backs[k] is None:  # delta codec: panel and mirror take the row
            y32 = row[k][None].expand(x.shape).contiguous()
            mixed[k] = y32.to(x.dtype)
            if new_err is not None:
                new_err[k] = (y32.clone() if x.dtype == torch.float32
                              else y32)
            continue
        mixed[k] = backs[k](row[k][None].expand(x.shape)
                            .to(enc[k].dtype).contiguous())
    return mixed, row, new_err
