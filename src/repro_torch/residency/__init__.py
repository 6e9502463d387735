"""Storage residency: compressed storage codecs for the engine's state
panels (see residency/storage.py for the contract).

The spec carries a per-state-kind policy (``panel.with_residency``); the
segment driver (core/dsgd.py) decodes the stored panels where a round
needs their float32 view and encodes them back in the same step."""
from repro_torch.residency.storage import (KINDS, SLAB,  # noqa: F401
                                           STORAGE, Bf16Storage,
                                           F32Storage, Int8Storage, Storage,
                                           get_storage, parse_policy,
                                           storage_generators)
