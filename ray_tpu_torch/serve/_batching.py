"""@serve.batch: transparent request batching inside a replica.

Reference: python/ray/serve/batching.py — individual calls queue up and the
wrapped function runs once per batch (list in, list out), amortizing model
invocation cost. Flush triggers: the batch reaches max_batch_size, or
batch_wait_timeout_s elapses since the first queued item.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import weakref
from typing import Any, Callable, Dict, List, Optional


class _BatchQueue:
    __slots__ = ("items", "timer")

    def __init__(self):
        # (item, future, deadline-or-0, trace-span-or-None)
        self.items: List[tuple] = []
        self.timer: Optional[asyncio.TimerHandle] = None


# queues for batched FREE functions, keyed WEAKLY by the wrapper function
# object — NOT by id(): CPython reuses ids after gc, which would cross-wire a
# new function's batch queue with a dead one's leftover state (advisor r2).
# Weak keying makes cleanup automatic in EVERY process the wrapper lands in
# (a cloudpickled copy on a replica is its own key; a weakref.finalize
# registered at decoration time would not survive the pickle round-trip).
# Module-level (not closure state): runtime queue state must not ride along
# when the wrapper travels to replicas by value via cloudpickle.
_free_queues: "weakref.WeakKeyDictionary[Callable, _BatchQueue]" = (
    weakref.WeakKeyDictionary()
)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorate an async function/method taking a LIST of requests and
    returning a LIST of responses; callers invoke it with single items."""

    def decorate(fn: Callable):
        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] == "self"

        def queue_for(self_obj, wrapper: Callable) -> _BatchQueue:
            if self_obj is None:
                # resolve the registry through the module at call time:
                # naming the global here would make cloudpickle capture the
                # (unpicklable, process-local) WeakKeyDictionary by value
                # when the wrapper ships to a replica
                from ray_tpu_torch.serve import _batching

                q = _batching._free_queues.get(wrapper)
                if q is None:
                    q = _batching._free_queues[wrapper] = _BatchQueue()
                return q
            # per-instance state lives ON the instance (picklable classes
            # must not capture queues in the decorator closure)
            queues = getattr(self_obj, "_rt_batch_queues", None)
            if queues is None:
                queues = {}
                self_obj._rt_batch_queues = queues
            q = queues.get(fn.__name__)
            if q is None:
                q = queues[fn.__name__] = _BatchQueue()
            return q

        async def flush(q: _BatchQueue, self_obj):
            if q.timer is not None:
                q.timer.cancel()
                q.timer = None
            items, q.items = q.items, []
            if not items:
                return
            # deadline-aware batch admission: a request whose end-to-end
            # deadline expired while waiting for the batch window must not
            # ride into the model invocation — its caller is gone, and its
            # slot in the batch would be pure waste. Fail it typed, run
            # the batch on the survivors.
            import time as _time

            from ray_tpu_torch.serve._errors import DeadlineExceededError

            now = _time.time()
            live, ctxs = [], []
            for it, fut, deadline, ctx in items:
                if deadline and now >= deadline:
                    if not fut.done():
                        fut.set_exception(DeadlineExceededError(
                            "request deadline expired in the batch queue"))
                else:
                    live.append((it, fut))
                    ctxs.append(ctx)
            items = live
            if not items:
                return
            batch_in = [it for it, _ in items]
            # batch-flush span: runs in a timer callback OUTSIDE any
            # request's context, so it parents explicitly to the first
            # rider's span captured at enqueue time — the batch hop shows
            # up on that request's trace with the batch size attached
            from ray_tpu_torch.util import tracing

            parent = next((c for c in ctxs if c is not None), None)
            with tracing.span(f"serve:batch:{fn.__name__}"
                              f"[n={len(items)}]", parent=parent):
                try:
                    out = (fn(self_obj, batch_in) if is_method
                           else fn(batch_in))
                    if inspect.isawaitable(out):
                        out = await out
                    if len(out) != len(items):
                        raise ValueError(
                            f"batched function returned {len(out)} results "
                            f"for {len(items)} requests"
                        )
                    for (_, fut), r in zip(items, out):
                        if not fut.done():
                            fut.set_result(r)
                except BaseException as e:  # noqa: BLE001 — fan the error out
                    for _, fut in items:
                        if not fut.done():
                            fut.set_exception(e)

        @functools.wraps(fn)
        async def wrapper(*call_args) -> Any:
            if is_method:
                self_obj, item = call_args
            else:
                (item,) = call_args
                self_obj = None
            loop = asyncio.get_running_loop()
            q = queue_for(self_obj, wrapper)
            fut = loop.create_future()
            # snapshot the caller's deadline AND trace span at ENQUEUE
            # time: the flush runs outside the request's context (timer
            # callback)
            from ray_tpu_torch.serve._context import get_request_deadline
            from ray_tpu_torch.util.tracing import current_span

            q.items.append((item, fut, get_request_deadline(),
                            current_span()))
            if len(q.items) >= max_batch_size:
                await flush(q, self_obj)
            elif q.timer is None:
                from ray_tpu_torch._private.aio import spawn

                q.timer = loop.call_later(
                    batch_wait_timeout_s,
                    lambda: spawn(flush(q, self_obj)),
                )
            return await fut

        wrapper._rt_batched = True  # introspection marker
        return wrapper

    if _fn is not None:
        return decorate(_fn)
    return decorate
