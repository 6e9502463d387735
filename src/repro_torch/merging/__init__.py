from repro_torch.merging.ops import (MERGERS, Merger,  # noqa: F401
                                     UniformMerger, get_merger, merge_panel)
