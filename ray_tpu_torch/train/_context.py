"""Worker-side training context: rank info, report(), barrier, checkpoint.
The port's copy of ``ray_tpu/train/_context.py``, with one difference: a
jax.Array carries its sharding and a tensor does not, so ``report`` takes
the state's ``specs``, ``mesh`` and ``shapes`` and hands them to the
checkpoint writer (``AsyncCheckpointWriter.save``). Without them every
leaf is saved whole, as a single-process JAX save writes it.

Reference surface: ray.train.get_context() / ray.train.report
(python/ray/train/v2/_internal/execution/context.py, train_loop_utils).
The context is installed by the TrainWorker actor before the user's
train_loop_per_worker runs on its thread.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.train._checkpoint import AsyncCheckpointWriter, Checkpoint

_local = threading.local()


@dataclass
class TrainContext:
    rank: int
    world_size: int
    local_rank: int
    node_rank: int
    run_name: str
    storage_path: str
    staging_dir_fn: Any  # step -> staging dir path
    latest_checkpoint: Optional[Checkpoint] = None
    report_queue: "queue.Queue[dict]" = field(default_factory=queue.Queue)
    stop_event: threading.Event = field(default_factory=threading.Event)
    _writer: AsyncCheckpointWriter = field(default_factory=AsyncCheckpointWriter)
    _sync_client: Any = None  # SyncActor handle, set by the worker
    # live-resize state: the gang generation this worker currently belongs
    # to (rank/world_size above are REWRITTEN by a committed resize) and
    # the worker-side protocol client (None for non-elastic runs)
    generation: int = 0
    elastic: Any = None

    # -- public API (mirrors ray.train.*) -------------------------------

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_generation(self) -> int:
        """Gang generation: bumped by every committed live resize."""
        return self.generation

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    def should_stop(self) -> bool:
        """Cooperative stop signal (controller shutdown / preemption)."""
        return self.stop_event.is_set()

    def report(self, metrics: Dict[str, Any],
               checkpoint_state: Optional[Any] = None, *, specs=None,
               mesh=None, shapes=None) -> None:
        """Report metrics (and optionally save a checkpoint shard).

        `checkpoint_state` is a pytree of tensors / numpy arrays; it is
        snapshotted to host synchronously and written to the run's staging
        directory for the reported step. The controller finalizes the
        checkpoint once every rank's shard has landed. `specs` and `mesh`
        say which leaves are this rank's blocks (and `shapes` their global
        shapes, else one all-reduce finds them): as for
        `AsyncCheckpointWriter.save`.
        """
        entry: Dict[str, Any] = {"metrics": dict(metrics), "rank": self.rank,
                                 "generation": self.generation}
        if checkpoint_state is not None:
            step = int(metrics.get("step", 0))
            staging = self.staging_dir_fn(step)
            fut = self._writer.save(
                checkpoint_state, staging, rank=self.rank,
                manifest={"metrics": dict(metrics), "rank": self.rank,
                          "world_size": self.world_size,
                          "generation": self.generation},
                specs=specs, mesh=mesh, shapes=shapes,
            )
            fut.result()  # surface write errors at the report site
            entry["checkpoint_step"] = step
        self.report_queue.put(entry)

    def barrier(self, name: str = "default", timeout: float = 300.0) -> None:
        """Block until every worker in the group reaches this barrier.

        Barriers are scoped by the gang generation: a straggler from
        generation N can never satisfy (or poison) generation N+1's
        barriers — its call fails fast with a stale-generation error."""
        if self._sync_client is None:
            return
        import ray_tpu_torch

        ray_tpu_torch.get(
            self._sync_client.barrier.remote(
                name, self.world_size, self.generation),
            timeout=timeout,
        )

    def broadcast_from_rank_zero(self, name: str, value: Any = None,
                                 timeout: float = 300.0) -> Any:
        """Rank 0 contributes `value`; every rank returns it. Rendezvous
        keys are generation-scoped like barriers."""
        if self._sync_client is None:
            return value
        import ray_tpu_torch

        if self.rank == 0:
            ray_tpu_torch.get(
                self._sync_client.put.remote(name, value, self.generation),
                timeout=timeout)
        return ray_tpu_torch.get(
            self._sync_client.wait_for.remote(name, 0.01, self.generation),
            timeout=timeout)


def get_context() -> TrainContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "ray_tpu_torch.train.get_context() called outside a train worker"
        )
    return ctx


def set_context(ctx: Optional[TrainContext]) -> None:
    _local.ctx = ctx


def report(metrics: Dict[str, Any],
           checkpoint_state: Optional[Any] = None, *, specs=None, mesh=None,
           shapes=None) -> None:
    get_context().report(metrics, checkpoint_state=checkpoint_state,
                         specs=specs, mesh=mesh, shapes=shapes)
