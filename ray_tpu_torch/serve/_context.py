"""Per-request serve context: the end-to-end deadline.

Reference: Ray Serve's `_serve_request_context` contextvar +
deadline-aware routing; The Tail at Scale's argument that a deadline set
once at ingress and PROPAGATED beats per-hop timeouts — every hop can
fail an already-dead request fast instead of doing work whose caller
gave up.

The deadline is an absolute epoch timestamp (`time.time()` seconds) so
it survives process hops: the handle stamps it into the request
(`__serve_deadline` reserved kwarg, like `__serve_model_id`), the
replica installs it in this contextvar before invoking user code, and
anything downstream — `@serve.batch` admission, nested handle calls,
user code via `serve.get_request_deadline()` — reads it from here.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

# 0.0 = no deadline
_deadline_var: contextvars.ContextVar[float] = contextvars.ContextVar(
    "rt_serve_deadline", default=0.0)

DEADLINE_KWARG = "__serve_deadline"


def get_request_deadline() -> float:
    """Absolute epoch deadline of the in-flight request (0.0 = none)."""
    return _deadline_var.get()


def remaining_s() -> Optional[float]:
    """Seconds left until the in-flight request's deadline (None = no
    deadline; never negative)."""
    d = _deadline_var.get()
    if not d:
        return None
    return max(0.0, d - time.time())


def expired(deadline: float) -> bool:
    return bool(deadline) and time.time() >= deadline


def _set_deadline(deadline: float):
    return _deadline_var.set(deadline)
