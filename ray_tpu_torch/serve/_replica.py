"""Serve replica actor: wraps one instance of the user's deployment callable.

Reference: python/ray/serve/_private/replica.py (UserCallableWrapper +
ReplicaActor). Each replica tracks in-flight requests for the controller's
autoscaling decisions and the handle's least-loaded routing.

Overload plane: admission control happens HERE, before any user code —
a bounded queue (`max_queued`) on top of the `max_concurrent` semaphore
rejects excess requests with a typed BackpressureError, and a request
whose end-to-end deadline is already (or becomes, while queued) expired
is failed with DeadlineExceededError without ever reaching the callable.
Counters prove both: `started` only moves when user code actually runs.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._context import DEADLINE_KWARG, _set_deadline, expired
from ray_tpu_torch.serve._errors import BackpressureError, DeadlineExceededError


@ray_tpu_torch.remote
class ServeReplica:
    """One serving process. Async actor: overlapping requests interleave on
    the event loop up to max_concurrent_queries; sync user callables run on
    a thread pool so they can't stall the loop (reference: replica.py runs
    sync callables in an executor)."""

    def __init__(self, deployment_name: str, replica_id: int,
                 callable_blob: bytes, init_args_blob: bytes,
                 max_concurrent: int = 100, max_queued: int = -1):
        import cloudpickle

        cls_or_fn = cloudpickle.loads(callable_blob)
        args, kwargs = cloudpickle.loads(init_args_blob)
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        if inspect.isclass(cls_or_fn):
            self._callable = cls_or_fn(*args, **kwargs)
        else:
            self._callable = cls_or_fn
        self._max_concurrent = max_concurrent
        self._max_queued = max_queued  # < 0 = unbounded
        self._ongoing = 0        # admitted: queued + running
        self._running = 0        # holding a concurrency slot
        self._peak_ongoing = 0   # high-water since last stats() poll
        self._peak_queued = 0    # high-water queue depth since last poll
        self._total = 0
        # overload-plane counters (asserted by tests and scraped by
        # bench_serve): `started` moves only when user code is invoked, so
        # started + shed + deadline_rejected partitions every admission
        self._shed = 0               # queue-bound rejections
        self._deadline_rejected = 0  # expired before user code ran
        self._deadline_stream = 0    # expired between stream chunks
        self._started = 0            # requests whose callable was invoked
        self._sem = asyncio.Semaphore(max_concurrent)
        self._pool = ThreadPoolExecutor(
            max_workers=min(32, max_concurrent),
            thread_name_prefix=f"serve-{deployment_name}",
        )
        self._started_at = time.time()

    # -- admission ------------------------------------------------------

    def _admit(self, deadline: float):
        """Gate a request BEFORE it occupies a queue slot. Deadline first:
        an expired request must not count against (or wait in) the queue."""
        if expired(deadline):
            self._deadline_rejected += 1
            raise DeadlineExceededError(
                f"deployment {self.deployment_name}: request deadline "
                f"expired before execution started")
        if (self._max_queued >= 0
                and self._ongoing >= self._max_concurrent + self._max_queued):
            self._shed += 1
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            raise BackpressureError(
                f"deployment {self.deployment_name} replica "
                f"{self.replica_id}: queue full "
                f"({self._ongoing - self._max_concurrent} queued >= "
                f"max_queued={self._max_queued})",
                retry_after_s=GLOBAL_CONFIG.get("serve_retry_after_s"))

    async def _acquire_slot(self, deadline: float):
        """Take a concurrency slot, waiting at most until the deadline —
        a request that dies in the queue never reaches the callable."""
        if not deadline:
            await self._sem.acquire()
            return
        remaining = deadline - time.time()
        try:
            await asyncio.wait_for(self._sem.acquire(), timeout=remaining)
        except (asyncio.TimeoutError, TimeoutError):
            self._deadline_rejected += 1
            raise DeadlineExceededError(
                f"deployment {self.deployment_name}: request deadline "
                f"expired while queued") from None

    def _track(self):
        self._ongoing += 1
        self._peak_ongoing = max(self._peak_ongoing, self._ongoing)
        # queue depth = admissions beyond the concurrency limit (a request
        # about to take a free slot is not "queued"); with the admission
        # gate this is provably <= max_queued
        queued = max(0, self._ongoing - self._max_concurrent)
        self._peak_queued = max(self._peak_queued, queued)
        self._total += 1

    # -- execution ------------------------------------------------------

    async def _run(self, fn, deadline, *args, **kwargs) -> Any:
        from ray_tpu_torch.util import tracing

        # admission span: queue-full sheds and deadline-expired rejections
        # are visible on the request's trace (chained under the actor-task
        # execution span, which chains to the ingress span)
        with tracing.span(f"replica:admit:{self.deployment_name}"):
            self._admit(deadline)
            self._track()
        try:
            await self._acquire_slot(deadline)
            self._running += 1
            self._started += 1
            try:
                if inspect.iscoroutinefunction(fn) or (
                    not inspect.isfunction(fn) and not inspect.ismethod(fn)
                    and inspect.iscoroutinefunction(
                        getattr(fn, "__call__", None))
                ):
                    return await fn(*args, **kwargs)
                # copy_context: run_in_executor does not propagate
                # contextvars (the multiplexed model id and request deadline
                # must be visible in sync callables; asyncio.to_thread does
                # this same dance)
                import contextvars

                ctx = contextvars.copy_context()
                result = await asyncio.get_running_loop().run_in_executor(
                    self._pool,
                    functools.partial(ctx.run, fn, *args, **kwargs),
                )
                if inspect.isawaitable(result):
                    result = await result
                return result
            finally:
                self._running -= 1
                self._sem.release()
        finally:
            self._ongoing -= 1

    def _install_request_context(self, kwargs) -> float:
        """Pop reserved routing kwargs and install the request context;
        returns the absolute deadline (0.0 = none)."""
        deadline = float(kwargs.pop(DEADLINE_KWARG, 0.0) or 0.0)
        _set_deadline(deadline)
        model_id = kwargs.pop("__serve_model_id", None)
        if model_id:
            # visible to serve.get_multiplexed_model_id() inside the request
            from ray_tpu_torch.serve._multiplex import _set_model_id

            _set_model_id(model_id)
        return deadline

    async def handle_request(self, *args, **kwargs) -> Any:
        fn = self._callable
        if not callable(fn):
            raise TypeError(
                f"deployment {self.deployment_name} is not callable")
        deadline = self._install_request_context(kwargs)
        result = await self._run(fn, deadline, *args, **kwargs)
        if inspect.isgenerator(result) or inspect.isasyncgen(result):
            raise TypeError(
                f"deployment {self.deployment_name} returned a generator "
                f"from the unary path — call it with "
                f"handle.options(stream=True) (HTTP: ?stream=1 or a "
                f'"stream": true body field)')
        return result

    async def handle_request_stream(self, *args, **kwargs):
        """Streaming request path (reference: proxy.py:1031 generator
        streaming through replica.py): drives a generator-returning callable
        and yields items onto the actor streaming plane. A non-generator
        result yields exactly once, so callers may stream unconditionally.
        The deadline is re-checked between chunks: a stream whose consumer's
        budget is spent stops burning compute mid-generation."""
        from ray_tpu_torch.util import tracing

        fn = self._callable
        deadline = self._install_request_context(kwargs)
        with tracing.span(f"replica:admit:{self.deployment_name}"):
            self._admit(deadline)
            self._track()
        sentinel = object()
        # manual span (not a `with`): the generator body runs across the
        # consumer's pulls — chunk count lands in the span name on close
        stream_sp = tracing.start_manual_span(
            f"replica:stream:{self.deployment_name}")
        n_chunks = 0
        try:
            await self._acquire_slot(deadline)
            self._running += 1
            self._started += 1
            try:
                result = fn(*args, **kwargs)
                if inspect.isawaitable(result):
                    result = await result
                if inspect.isasyncgen(result):
                    async for item in result:
                        self._check_stream_deadline(deadline)
                        n_chunks += 1
                        yield item
                elif inspect.isgenerator(result):
                    # a sync generator's next() may block (device steps):
                    # drive it on the pool so the replica loop stays live
                    loop = asyncio.get_running_loop()
                    while True:
                        item = await loop.run_in_executor(
                            self._pool, next, result, sentinel)
                        if item is sentinel:
                            break
                        self._check_stream_deadline(deadline)
                        n_chunks += 1
                        yield item
                else:
                    n_chunks += 1
                    yield result
            finally:
                self._running -= 1
                self._sem.release()
        finally:
            self._ongoing -= 1
            tracing.end_manual_span(stream_sp, chunks=n_chunks)

    def _check_stream_deadline(self, deadline: float):
        if expired(deadline):
            self._deadline_stream += 1
            raise DeadlineExceededError(
                f"deployment {self.deployment_name}: request deadline "
                f"expired mid-stream")

    async def call_method(self, method: str, *args, **kwargs) -> Any:
        deadline = self._install_request_context(kwargs)
        return await self._run(getattr(self._callable, method), deadline,
                               *args, **kwargs)

    async def stats(self) -> dict:
        # peak-since-last-poll: a burst shorter than the controller's poll
        # period must still be visible to the autoscaler (the reference uses
        # time-windowed request metrics for the same reason)
        peak = self._peak_ongoing
        self._peak_ongoing = self._ongoing
        # peak_queued resets on poll too: a monotonic high-water would keep
        # feeding the spike-era queue depth to the autoscaler as live load,
        # pinning the fleet at max_replicas after traffic drains
        peak_q = self._peak_queued
        self._peak_queued = max(0, self._ongoing - self._max_concurrent)
        out = {
            "replica_id": self.replica_id,
            "ongoing": self._ongoing,
            "queued": max(0, self._ongoing - self._max_concurrent),
            "peak_ongoing": peak,
            "peak_queued": peak_q,
            "total": self._total,
            "started": self._started,
            "shed": self._shed,
            "deadline_rejected": self._deadline_rejected,
            "deadline_mid_stream": self._deadline_stream,
            "max_concurrent": self._max_concurrent,
            "max_queued": self._max_queued,
            "uptime_s": time.time() - self._started_at,
        }
        # autoscaling-signal passthrough: a callable exposing
        # autoscaling_stats() (LLM engines: ttft_p50_s, tokens_per_s) rides
        # the controller's existing stats probe — serve-layer keys win
        hook = getattr(self._callable, "autoscaling_stats", None)
        if hook is not None:
            try:
                extra = hook()
                if asyncio.iscoroutine(extra):
                    extra = await extra
                if isinstance(extra, dict):
                    for k, v in extra.items():
                        out.setdefault(k, v)
            except Exception:  # noqa: BLE001 — signals are optional
                pass
        return out

    async def queue_len(self) -> int:
        """Current in-flight count for the routers' cross-handle load cache
        (reference: pow_2_router.py:27 queue-length probes)."""
        return self._ongoing

    async def health(self) -> bool:
        check = getattr(self._callable, "check_health", None)
        if check is not None:
            result = check()
            if inspect.isawaitable(result):
                await result
        return True
