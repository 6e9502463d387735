"""Merge-operator registry (see merging/ops.py for the contract)."""
from repro_torch.merging.ops import (MERGERS, FisherMerger,  # noqa: F401
                                     Merger, SwaMerger, TiesMerger,
                                     UniformMerger, VarMerger,
                                     WeightedMerger, decode_stats,
                                     get_merger, merge_panel)
