"""ray_tpu_torch.train — distributed training on GPU gangs: the port of
``ray_tpu/train``.

Capability parity with Ray Train v2 (reference: python/ray/train/v2/):
controller + worker group + scaling/failure policies + checkpoint manager +
report/barrier, with TorchTrainer (the JAX package's JaxTrainer) as the
entry point, checkpoints in the JAX package's on-disk layout, and stage
actors for pipeline parallelism (``pipeline_actors``). Importing it imports
no torch: the controller runs in a driver that holds no tensor.
"""

from ray_tpu_torch.train._checkpoint import (AsyncCheckpointWriter,
                                             Checkpoint, CheckpointManager,
                                             global_leaf_shapes,
                                             load_train_state,
                                             snapshot_to_host,
                                             snapshot_with_meta,
                                             staging_dir_name,
                                             train_state_specs,
                                             train_state_tree)
from ray_tpu_torch.train._context import TrainContext, get_context, report
from ray_tpu_torch.train._controller import TrainController, TrainResult
from ray_tpu_torch.train._elastic import (
    ElasticClient,
    ElasticDataIterator,
    ResizeOutcome,
)
from ray_tpu_torch.train._policies import (
    ElasticScalingPolicy,
    FailurePolicy,
    FixedScalingPolicy,
    usable_cluster_resources,
)
from ray_tpu_torch.train._storage import StorageContext, get_storage
from ray_tpu_torch.train._worker_group import (SyncActor, TrainWorker,
                                               WorkerGroup)
from ray_tpu_torch.train.trainer import (
    CheckpointConfig,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    TrainingFailedError,
    setup_torch_distributed,
)

__all__ = [
    "AsyncCheckpointWriter",
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "DataParallelTrainer",
    "ElasticClient",
    "ElasticDataIterator",
    "ElasticScalingPolicy",
    "ResizeOutcome",
    "FailureConfig",
    "FailurePolicy",
    "FixedScalingPolicy",
    "RunConfig",
    "ScalingConfig",
    "StorageContext",
    "SyncActor",
    "TorchTrainer",
    "TrainContext",
    "TrainController",
    "TrainResult",
    "TrainWorker",
    "TrainingFailedError",
    "WorkerGroup",
    "get_context",
    "get_storage",
    "global_leaf_shapes",
    "load_train_state",
    "report",
    "setup_torch_distributed",
    "snapshot_to_host",
    "snapshot_with_meta",
    "staging_dir_name",
    "train_state_specs",
    "train_state_tree",
    "usable_cluster_resources",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("train")
del _rlu
