"""paddle_tpu_torch.checkpoint: the checkpoint manifest, the commit point
of a checkpoint directory (``manifest.py``, copied from the JAX package,
which keeps it free of jax).  ``io.save_persistables`` writes one beside
its flat ``__params__.npz``, and ``io.load_persistables`` reads through it,
so a directory either package saves loads in the other.  The async
sharded ``CheckpointManager`` is not ported yet (ROADMAP §A item 4)."""
from .manifest import (CheckpointError, checkpoint_dir, latest_step,  # noqa: F401
                       list_steps, read_manifest, validate_shards)

__all__ = ["CheckpointError", "checkpoint_dir", "latest_step", "list_steps",
           "read_manifest", "validate_shards"]
