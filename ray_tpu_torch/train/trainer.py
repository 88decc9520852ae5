"""Public Train API: configs + DataParallelTrainer + TorchTrainer.

Reference surface: ray.train.ScalingConfig/RunConfig/FailureConfig/
CheckpointConfig (python/ray/train/), DataParallelTrainer
(train/v2/api/data_parallel_trainer.py:66) and the JAX package's JaxTrainer
(``ray_tpu/train/trainer.py``; reference: train/v2/jax/jax_trainer.py:20,
config.py:40-121), ported as TorchTrainer.

The port's copy of ``ray_tpu/train/trainer.py``. TorchTrainer's workers form
a torch.distributed group: rank 0's host is the rendezvous (the address the
worker group injects, as JaxConfig's `_setup_jax_distributed_environment`
does for jax.distributed), and `setup_torch_distributed` joins it, NCCL
where the worker sees CUDA. JAX's topology-aware placement of whole TPU
slices is the reservation of a whole NVLink domain here: with `use_gpu`,
`topology` ("HxG") reserves a domain of the pod type `accelerator_type`
names (a node's ``gpu-pod-type`` label, e.g. "H100-8"; ``gpu/slice.py``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train._checkpoint import CheckpointManager
from ray_tpu_torch.train._controller import TrainController, TrainResult
from ray_tpu_torch.train._policies import (
    ElasticScalingPolicy,
    FailurePolicy,
    FixedScalingPolicy,
)
from ray_tpu_torch.train._worker_group import destroy_process_group


@dataclass
class ScalingConfig:
    """Reference: ray.train.ScalingConfig (+ the accelerator fields of
    v2/jax/config.py: `use_gpu` for JAX's `use_tpu`; with it, `topology`
    ("HxG": H hosts of G devices) reserves a whole NVLink domain of the pod
    type `accelerator_type` names, as JAX's reserves a TPU slice; without
    `topology`, as in JAX, no domain is reserved).

    Setting `elastic_min_workers` makes the run ELASTIC: the group sizes
    to current usable capacity within [elastic_min_workers, num_workers],
    and — when the train fn drives `ctx.elastic.sync()` each step — a
    planned node removal (drain/preemption) with enough survivors resizes
    the live gang instead of tearing it down, re-expanding when capacity
    returns (see train/_elastic.py; knob: `train_live_resize`)."""

    num_workers: int = 1
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    use_gpu: bool = False
    topology: str = ""  # e.g. "1x8" — reserves a whole domain when use_gpu
    accelerator_type: str = ""  # e.g. "H100-8"
    elastic_min_workers: Optional[int] = None  # set → elastic scaling

    @property
    def use_gpu_domain(self) -> bool:
        return bool(self.use_gpu and self.topology)

    def policy(self):
        if self.elastic_min_workers is not None:
            return ElasticScalingPolicy(self.elastic_min_workers,
                                        self.num_workers)
        return FixedScalingPolicy(self.num_workers)

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker)
        if not res:
            res = {"CPU": 1.0}
        return res


@dataclass
class FailureConfig:
    """Reference: ray.train.FailureConfig."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Reference: ray.train.CheckpointConfig."""

    num_to_keep: int = 2
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "min"


@dataclass
class RunConfig:
    """Reference: ray.train.RunConfig."""

    name: str = ""
    storage_path: str = ""
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)

    def resolved_name(self) -> str:
        return self.name or f"train-run-{int(time.time())}"

    def resolved_storage(self) -> str:
        return self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results"
        )


class DataParallelTrainer:
    """Runs `train_loop_per_worker` on N gang-scheduled workers.

    Reference: train/v2/api/data_parallel_trainer.py:66. fit() drives the
    controller loop synchronously and returns a TrainResult.
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()

    def _controller(self) -> TrainController:
        run_name = self.run_config.resolved_name()
        storage = self.run_config.resolved_storage()
        cc = self.run_config.checkpoint_config
        manager = CheckpointManager(
            storage, run_name,
            num_to_keep=cc.num_to_keep,
            metric=cc.checkpoint_score_attribute,
            mode=cc.checkpoint_score_order,
        )
        return TrainController(
            train_fn=self.train_loop_per_worker,
            train_config=self.train_loop_config,
            scaling_policy=self.scaling_config.policy(),
            failure_policy=FailurePolicy(
                self.run_config.failure_config.max_failures
            ),
            resources_per_worker=self.scaling_config.worker_resources(),
            run_name=run_name,
            storage_path=storage,
            checkpoint_manager=manager,
            use_gpu_domain=self.scaling_config.use_gpu_domain,
            topology=self.scaling_config.topology,
            accelerator_type=self.scaling_config.accelerator_type,
        )

    def fit(self) -> TrainResult:
        result = self._controller().run()
        if result.error is not None:
            raise TrainingFailedError(result.error)
        return result


class TrainingFailedError(RuntimeError):
    """Training exhausted its failure budget (reference: TrainingFailedError)."""


class TorchTrainer(DataParallelTrainer):
    """Data-parallel torch training over a GPU gang (the JAX package's
    JaxTrainer, ``ray_tpu/train/trainer.py:155``; reference:
    v2/jax/jax_trainer.py:20, and Ray Train's TorchTrainer).

    The train loop runs once per worker process; call
    `ray_tpu_torch.train.setup_torch_distributed()` first thing inside it
    to join the run's process group (rendezvous address + rank/world size
    are injected by the worker group). With `use_gpu` and no
    `resources_per_worker` a worker takes `{"GPU": 1}`: one process per
    device, torch's idiom (JAX's default, `{"TPU": 4}`, is one process per
    host owning all its chips).
    """

    def __init__(self, train_loop_per_worker: Callable, **kwargs):
        scaling = kwargs.get("scaling_config") or ScalingConfig()
        if scaling.use_gpu and not scaling.resources_per_worker:
            scaling.resources_per_worker = {"GPU": 1.0}
        kwargs["scaling_config"] = scaling
        super().__init__(train_loop_per_worker, **kwargs)


def setup_torch_distributed(backend: Optional[str] = None):
    """Join the run's torch.distributed group from inside a train worker;
    returns this worker's device: ``cuda:0`` of its CUDA_VISIBLE_DEVICES
    (a GPU lease narrows it to the worker's devices), else ``cpu``.

    Uses the rendezvous/rank env vars injected by the worker group
    (RT_TRAIN_COORDINATOR / RT_TRAIN_RANK / RT_TRAIN_WORLD_SIZE — the
    contract of the JAX package's setup_jax_distributed): a TCP rendezvous
    at the coordinator, NCCL where the worker sees CUDA, gloo otherwise or
    when `backend` names it. A group this process already has is destroyed
    first, so a gang initialises again in the same processes (after a
    live resize, say); every rank passes the worker group's barrier
    between the destroy and the new rendezvous, so no rank reaches rank
    0's rendezvous server of the group before. No-op for a single-worker
    run, as in JAX.
    """
    import torch
    import torch.distributed as dist

    cuda = torch.cuda.is_available()
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    world = int(os.environ.get("RT_TRAIN_WORLD_SIZE", "1"))
    if world <= 1:
        return device
    from ray_tpu_torch.train._context import get_context

    destroy_process_group()
    get_context().barrier("setup_torch_distributed")
    dist.init_process_group(
        backend=backend or ("nccl" if cuda else "gloo"),
        init_method="tcp://" + os.environ["RT_TRAIN_COORDINATOR"],
        rank=int(os.environ["RT_TRAIN_RANK"]), world_size=world)
    return device
