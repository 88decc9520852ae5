"""Exception hierarchy for the framework.

Capability parity with the reference's error model (reference: src/ray/common/status.h and
python/ray/exceptions.py): user-code exceptions are captured with tracebacks and re-raised
at `get()`; system failures map onto typed errors so callers can distinguish retryable
infrastructure faults from application bugs.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class RayTpuSystemError(RayTpuError):
    """Internal invariant violation — a framework bug, not a user bug."""


class TaskError(RayTpuError):
    """A task raised an exception; wraps the remote traceback.

    Re-raised from `ray_tpu_torch.get` on the caller. The original exception is
    chained as __cause__ when it could be pickled.
    """

    def __init__(self, function_name: str, traceback_str: str, cause: BaseException | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        msg = f"Task {function_name} failed:\n{traceback_str}"
        super().__init__(msg)
        if cause is not None:
            self.__cause__ = cause

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, tb, cause=exc)

    def __reduce__(self):
        # Exceptions pickle by re-calling __init__ with self.args, which does
        # not match this signature; rebuild explicitly. The cause is carried
        # when picklable (its traceback is already flattened into the string).
        cause = self.__cause__
        try:
            import pickle

            pickle.dumps(cause)
        except Exception:  # noqa: BLE001
            cause = None
        return (type(self), (self.function_name, self.traceback_str, cause))


class WorkerCrashedError(RayTpuError):
    """The worker process executing a task died unexpectedly."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ray_tpu_torch.cancel() (reference:
    python/ray/exceptions.py TaskCancelledError) — raised by `get()` on any of
    the cancelled task's return refs and inside a cancelled running task."""


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead and will not be restarted (restarts exhausted or killed)."""


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (restarting); calls may be retried."""


class ObjectLostError(RayTpuError):
    """An object's value was lost from the cluster and could not be reconstructed."""

    def __init__(self, object_id_hex: str, reason: str = ""):
        self.object_id_hex = object_id_hex
        super().__init__(f"Object {object_id_hex} lost. {reason}")


class OwnerDiedError(ObjectLostError):
    """The object's owner process died, so its value can no longer be resolved."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`ray_tpu_torch.get(..., timeout=)` expired before the object was ready."""


class PlacementGroupError(RayTpuError):
    pass


class PlacementGroupUnschedulableError(PlacementGroupError):
    """No feasible gang placement exists for the requested bundles."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing a task/actor runtime environment failed."""


class NodeDiedError(RayTpuError):
    """A node was declared dead by the control store health checker."""


class RpcError(RayTpuError):
    """A control-plane RPC failed (possibly injected by chaos testing)."""


class ObjectStoreFullError(RayTpuError):
    """The shared-memory object store could not allocate after eviction/spill."""
