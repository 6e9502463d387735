from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointCorruptError,
    Checkpointer,
    ShardedCheckpointer,
    assemble,
    restore,
    restore_latest,
    save,
)
