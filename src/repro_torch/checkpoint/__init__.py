from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointCorruptError,
    Checkpointer,
    restore,
    save,
)
