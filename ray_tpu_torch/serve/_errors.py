"""Typed overload/deadline errors for the serve plane.

Reference: Ray Serve's BackPressureError (raised when
`max_queued_requests` is exceeded) and deadline-aware request routing;
the shapes here follow the overload-control literature — admission
failures are TYPED so every hop (replica, handle, HTTP/gRPC ingress) can
map them without string matching: BackpressureError -> 503 + Retry-After
/ RESOURCE_EXHAUSTED, DeadlineExceededError -> 504 / DEADLINE_EXCEEDED.

Both errors cross the task-error plane wrapped in TaskError with the
original chained as __cause__; `unwrap()` recovers the typed error on
the caller side.
"""

from __future__ import annotations

from ray_tpu_torch._private.errors import RayTpuError, TaskError


class BackpressureError(RayTpuError):
    """Request rejected by admission control: the replica's bounded queue
    is full, or every replica's probed load is saturated (ingress shed).
    Retryable — `retry_after_s` is the suggested backoff and becomes the
    HTTP Retry-After header."""

    def __init__(self, message: str = "request shed: system overloaded",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",
                             self.retry_after_s))


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's end-to-end deadline expired. Raised BEFORE user code
    runs when the deadline is already spent (ingress, queue wait, batch
    admission) and between stream chunks afterwards — dead requests never
    burn compute. Not retried: the caller already gave up."""


def unwrap(exc: BaseException) -> BaseException:
    """Recover the typed serve error from a TaskError wrapper (replica
    exceptions arrive at get() wrapped with the original as __cause__)."""
    if isinstance(exc, TaskError) and isinstance(
            exc.__cause__, (BackpressureError, DeadlineExceededError)):
        return exc.__cause__
    return exc
