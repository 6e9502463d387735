"""Merge operators, main-path subset (counterpart of ``repro/merging/ops.py``).

The paper's single global merging is the uniform column mean of the panel;
the statistical operators (weighted, var, fisher, ties, swa) arrive with
their slice.
"""
from __future__ import annotations

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
