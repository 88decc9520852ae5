"""joblib backend running batches as ray_tpu_torch tasks.

Reference surface: python/ray/util/joblib/ — `register_ray()` +
`joblib.parallel_backend("ray")` make scikit-learn style `joblib.Parallel`
workloads fan out over the cluster. Original implementation over ray_tpu_torch
tasks via joblib's ParallelBackendBase plugin API.
"""

from __future__ import annotations

from typing import Any

import ray_tpu_torch

try:
    from joblib import register_parallel_backend
    from joblib.parallel import ParallelBackendBase

    _HAVE_JOBLIB = True
except ImportError:  # pragma: no cover — joblib is optional
    _HAVE_JOBLIB = False
    ParallelBackendBase = object  # type: ignore[assignment,misc]


@ray_tpu_torch.remote
def _run_batch(batch) -> list:
    return batch()  # joblib BatchedCalls is itself callable


class _RayTpuFuture:
    """joblib expects a future with get(timeout) (the multiprocessing
    AsyncResult shape)."""

    def __init__(self, ref, callback):
        self._ref = ref
        self._callback = callback
        self._value = None
        self._have = False

    def get(self, timeout: Any = None):
        if not self._have:
            self._value = ray_tpu_torch.get(self._ref, timeout=timeout)
            self._have = True
        return self._value


class RayTpuBackend(ParallelBackendBase):
    """Submit each joblib batch as one remote task."""

    supports_timeout = True
    uses_threads = False
    supports_sharedmem = False

    def configure(self, n_jobs: int = 1, parallel=None, **kwargs):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.parallel = parallel
        return self.effective_n_jobs(n_jobs)

    def effective_n_jobs(self, n_jobs: int) -> int:
        if n_jobs == 0:
            raise ValueError("n_jobs == 0 has no meaning")
        cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        if n_jobs is None or n_jobs < 0:
            return max(1, cpus)
        return n_jobs

    def apply_async(self, func, callback=None):
        ref = _run_batch.remote(func)
        future = _RayTpuFuture(ref, callback)
        if callback is not None:
            # joblib drives retrieval itself; deliver the callback on a
            # completion wait in the submitting thread via ray wait-poll
            import threading

            def _notify():
                try:
                    value = future.get()
                    callback(value)
                except Exception:  # noqa: BLE001 — joblib retrieves the error
                    callback(None)

            threading.Thread(target=_notify, daemon=True).start()
        return future

    def abort_everything(self, ensure_ready: bool = True):
        if ensure_ready:
            self.configure(n_jobs=self.parallel.n_jobs,
                           parallel=self.parallel)


def register_ray_tpu() -> None:
    """Make `joblib.parallel_backend("ray_tpu_torch")` available (the JAX
    package's function name, the port's backend name)."""
    if not _HAVE_JOBLIB:
        raise ImportError("joblib is not installed")
    register_parallel_backend("ray_tpu_torch", RayTpuBackend)


__all__ = ["RayTpuBackend", "register_ray_tpu"]
