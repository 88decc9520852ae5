"""Checkpoints for the port — counterpart of ``ray_tpu/train``'s
checkpoint stack (``_checkpoint.py``, ``_storage.py``), in the JAX
package's on-disk layout. The trainer and the actor pipeline wait for the
port's actor runtime."""

from ray_tpu_torch.train._checkpoint import (AsyncCheckpointWriter,
                                             Checkpoint, CheckpointManager,
                                             global_leaf_shapes,
                                             load_train_state,
                                             snapshot_to_host,
                                             snapshot_with_meta,
                                             staging_dir_name,
                                             train_state_specs,
                                             train_state_tree)
from ray_tpu_torch.train._storage import StorageContext, get_storage

__all__ = ["AsyncCheckpointWriter", "Checkpoint", "CheckpointManager",
           "StorageContext", "get_storage", "global_leaf_shapes",
           "load_train_state", "snapshot_to_host", "snapshot_with_meta",
           "staging_dir_name", "train_state_specs", "train_state_tree"]
