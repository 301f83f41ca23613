"""paddle_tpu_torch.checkpoint: async checkpointing with restore in place,
in the JAX package's on-disk format.

``manifest.py`` (copied from the JAX package, free of jax) is the commit
point of a checkpoint directory; ``io.save_persistables`` writes one
beside its flat ``__params__.npz`` and ``io.load_persistables`` reads
through it.  ``manager.py`` is the ``CheckpointManager``: snapshots taken
as one wave of copies to pinned memory behind the step, serialization and
the atomic commit on a writer thread, keep-last-K retention, and restores
that copy into the scope's tensors (the step's CUDA graph replays on).
``Trainer(checkpoint=CheckpointConfig(...))`` wires periodic saves,
resume from the latest checkpoint, and the health layer's rollback and
save-on-fetch-timeout.  A directory either package writes restores in the
other; on one card a checkpoint has one shard (resharding onto a mesh
waits for ROADMAP §A item 12c)."""
from .manager import (CHECKPOINT_SCOPE, CKPT_RECORDS, CheckpointConfig,  # noqa: F401
                      CheckpointManager, restore_fit_dir,
                      snapshot_program_state)
from .manifest import (CheckpointError, checkpoint_dir, latest_step,  # noqa: F401
                       list_steps, read_manifest, validate_shards)

__all__ = [
    "CHECKPOINT_SCOPE", "CKPT_RECORDS", "CheckpointConfig",
    "CheckpointManager", "CheckpointError", "checkpoint_dir",
    "latest_step", "list_steps", "read_manifest", "restore_fit_dir",
    "snapshot_program_state", "validate_shards",
]
