"""Callee-side task execution.

Capability parity with the reference's execution pipeline (reference:
src/ray/core_worker/task_execution/task_receiver.h, concurrency_group_manager.h,
and the Python seam _raylet.pyx:2540 task_execution_handler /
:2326 execute_task_with_cancellation_handler):

- normal tasks run serially on a dedicated executor thread;
- actor creation instantiates the user class and pins it in-process;
- sync actor tasks are executed in per-caller sequence order (reorder buffer
  keyed by (caller, seq_no), matching SequentialActorSubmitQueue semantics);
  a missing predecessor fails the waiting task after a timeout rather than
  ever executing out of order;
- async actors run methods as coroutines bounded by max_concurrency;
- threaded actors use a pool of max_concurrency threads;
- duplicate deliveries (client retries after reconnect) are answered from a
  bounded reply cache keyed by task id; a retry that races the original
  in-flight execution coalesces onto the same future instead of running the
  method twice.
"""

from __future__ import annotations

import asyncio
import ctypes
import inspect
import logging
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private import protocol as pb
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.errors import TaskCancelledError, TaskError
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.runtime.object_store import META_NORMAL
from ray_tpu_torch.util.tracing import bind_generator, bind_span, execution_span

logger = logging.getLogger(__name__)

_STREAM_END = object()  # sentinel: sync generator exhausted (StopIteration
# cannot cross run_in_executor futures cleanly)


class _StaleSequenceError(Exception):
    """An ordered actor task arrived with a seq below the current window and
    no cached reply — either a duplicate whose reply cache entry expired or a
    late delivery of a predecessor already declared lost. Executing it now
    would reorder actor-state mutations, so it is rejected."""


class TaskExecutor:
    def __init__(self, core_worker):
        self.cw = core_worker
        self.thread_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="task-exec")
        self.actor_instance: Any = None
        self.actor_spec = None
        self._actor_sem: Optional[asyncio.Semaphore] = None
        # named concurrency groups (reference: concurrency_group_manager.h)
        self._group_pools: Dict[str, ThreadPoolExecutor] = {}
        self._group_sems: Dict[str, asyncio.Semaphore] = {}
        # per-caller ordering for sync actors (keyed by caller; ordering holds
        # within the newest incarnation the caller has shown us)
        self._expected_seq: Dict[bytes, int] = {}
        self._caller_incarnation: Dict[bytes, int] = {}
        self._buffered: Dict[bytes, Dict[int, asyncio.Event]] = {}
        self._reply_cache: "OrderedDict[bytes, dict]" = OrderedDict()
        self._in_flight: Dict[bytes, asyncio.Future] = {}
        self._exec_lock = asyncio.Lock()
        # cancellation state (reference: core_worker.proto CancelTask +
        # _raylet.pyx execute_task_with_cancellation_handler)
        self._cancelled: set = set()
        self._running_threads: Dict[bytes, int] = {}   # task id -> thread ident
        self._running_atasks: Dict[bytes, asyncio.Task] = {}

    # ------------------------------------------------------------------
    # cancellation
    # ------------------------------------------------------------------

    def cancel(self, tid: bytes, force: bool = False) -> dict:
        """Cancel a queued or running task on this worker.

        Sync tasks get TaskCancelledError raised asynchronously into their
        executor thread (the reference raises KeyboardInterrupt into the
        worker main thread); async tasks get their asyncio task cancelled;
        `force` kills the whole worker process after replying."""
        self._cancelled.add(tid)
        running = tid in self._in_flight
        if force:
            loop = asyncio.get_running_loop()
            loop.call_later(0.05, os._exit, 1)
            return {"ok": True, "running": running, "force": True}
        ident = self._running_threads.get(tid)
        if ident is not None:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), ctypes.py_object(TaskCancelledError)
            )
        atask = self._running_atasks.get(tid)
        if atask is not None:
            atask.cancel()
        return {"ok": True, "running": running}

    def _record_span(self, spec):
        """Span recorder bound to one spec: emits a SPAN task event carrying
        trace/span/parent ids (read back by util.tracing.list_spans and the
        timeline; reference: spans flushed through the task-event plane)."""
        def rec(span):
            self.cw.task_events.record(
                task_id=spec.task_id.binary(),
                name=span["name"], kind=spec.kind, event="SPAN",
                worker_id=self.cw.worker_id.binary(),
                node_id=self.cw.node_id_hex or "",
                ts=span["start"],
                duration_s=span["end"] - span["start"],
                extra={"trace_id": span["trace_id"],
                       "span_id": span["span_id"],
                       "parent_span_id": span["parent_span_id"]},
            )
        return rec

    def _call_traced(self, tid: bytes, fn, *args, **kwargs):
        """Run `fn` on this pool thread with the thread ident registered so
        cancel() can raise into it. The ident is cleared before returning;
        a cancel landing in the tiny window after clearing is benign (the
        async exc is delivered at a later bytecode boundary and surfaces as
        a TaskCancelledError in whatever task runs next — matching the
        reference's best-effort interrupt semantics)."""
        self._running_threads[tid] = threading.get_ident()
        try:
            return fn(*args, **kwargs)
        finally:
            self._running_threads.pop(tid, None)

    # ------------------------------------------------------------------

    async def execute(self, spec: pb.TaskSpec) -> dict:
        tid = spec.task_id.binary()
        cached = self._reply_cache.get(tid)
        if cached is not None:
            return cached
        # A client retry arriving while the original delivery is still
        # executing must not run the method a second time — coalesce onto
        # the in-flight execution's future.
        inflight = self._in_flight.get(tid)
        if inflight is not None:
            return await asyncio.shield(inflight)
        fut = asyncio.get_running_loop().create_future()
        self._in_flight[tid] = fut
        t0 = time.time()
        try:
            if spec.kind == pb.TASK_KIND_NORMAL:
                reply = await self._execute_normal(spec)
            elif spec.kind == pb.TASK_KIND_ACTOR_CREATION:
                reply = await self._execute_actor_creation(spec)
            else:
                reply = await self._execute_actor_task(spec)
            fut.set_result(reply)
        except BaseException as e:  # noqa: BLE001 — propagate to duplicates too
            fut.set_exception(e)
            # an un-awaited duplicate future must not warn on GC
            fut.exception()
            raise
        finally:
            self._in_flight.pop(tid, None)
            self._cancelled.discard(tid)
        # task-event history for the timeline / state API (reference:
        # profile_event.h execution spans flushed to GcsTaskManager)
        self.cw.task_events.record(
            task_id=tid,
            name=spec.name or spec.method_name or spec.function_key,
            kind=spec.kind,
            event="FAILED" if reply.get("error") else "FINISHED",
            worker_id=self.cw.worker_id.binary(),
            node_id=self.cw.node_id_hex or "",
            duration_s=time.time() - t0,
        )
        if spec.kind == pb.TASK_KIND_ACTOR_TASK:
            self._reply_cache[tid] = reply
            while len(self._reply_cache) > 1024:
                self._reply_cache.popitem(last=False)
        return reply

    # ------------------------------------------------------------------
    # batched execution (reference: pipelined PushNormalTask delivery) —
    # one thread-pool hop per batch instead of per task: on a contended
    # host the SimpleQueue wake + context switch per hop costs more than
    # executing a small task.
    # ------------------------------------------------------------------

    async def execute_batch(self, specs) -> list:
        replies: list = [None] * len(specs)
        # slow-path specs dispatch CONCURRENTLY (awaiting each inline would
        # serialize async/threaded/concurrency-group actors that must
        # overlap); plain sync tasks still serialize on the single executor
        # thread, preserving the one-lease-one-task resource model
        slow: list = []
        i = 0
        n = len(specs)
        while i < n:
            group: list = []
            group_seq: Dict[bytes, int] = {}
            start = i
            while i < n and await self._fast_prep(specs[i], group, group_seq):
                i += 1
            if group:
                for j, r in enumerate(await self._execute_fast_group(group)):
                    replies[start + j] = r
            if i < n:
                slow.append((i, asyncio.ensure_future(self.execute(specs[i]))))
                i += 1
        for idx, task in slow:
            try:
                replies[idx] = await task
            except asyncio.CancelledError as e:
                cur = asyncio.current_task()
                if cur is not None and cur.cancelling():
                    # THIS batch is being cancelled: don't abandon
                    # already-dispatched siblings un-awaited (un-retrieved
                    # exceptions warn at GC); reap them first
                    for _, t in slow:
                        t.cancel()
                    await asyncio.gather(
                        *[t for _, t in slow], return_exceptions=True)
                    raise
                # a sibling batch's duplicate delivery of this task was
                # cancelled and the coalesced future propagated it — that is
                # a per-task outcome, not cancellation of this batch
                replies[idx] = self._error_reply(specs[idx], e)
            except BaseException as e:  # noqa: BLE001 — isolate per task
                # an internal slow-path failure must not invalidate sibling
                # replies: the caller's feeder would treat the WHOLE batch as
                # worker-crashed and re-execute already-completed normal
                # tasks (side effects twice; advisor r3) — convert to a
                # per-task error reply like the fast group does
                replies[idx] = self._error_reply(specs[idx], e)
        return replies

    async def _fast_prep(self, spec: pb.TaskSpec, group: list,
                         group_seq: Dict[bytes, int]) -> bool:
        """If `spec` is eligible for grouped sync execution, append its
        prepped entry (fn resolved, args deserialized, in-flight future
        registered) to `group` and return True.

        Normal tasks are eligible unless streaming/async/duplicate. An actor
        task is eligible only when it is EXACTLY the next in its caller's
        sequence window (simulated through the group via `group_seq`) on a
        plain sync actor — anything else (reorder-buffer waits, async/
        threaded actors, tombstones, concurrency groups) takes the slow
        path, which owns those semantics."""
        if spec.is_streaming:
            return False
        tid = spec.task_id.binary()
        if tid in self._in_flight or tid in self._reply_cache:
            return False  # duplicate delivery: the slow path coalesces
        if spec.kind == pb.TASK_KIND_ACTOR_TASK:
            if (self.actor_instance is None or spec.cancelled
                    or spec.concurrency_group):
                return False
            aspec = self.actor_spec
            if aspec is None or aspec.is_async_actor or (
                    aspec.max_concurrency > 1 or aspec.concurrency_groups):
                return False
            caller = spec.owner_worker_id
            if spec.incarnation != self._caller_incarnation.get(
                    caller, spec.incarnation):
                return False
            expected = group_seq.get(
                caller, self._expected_seq.get(caller, 1))
            if spec.seq_no >= 0 and spec.seq_no != expected:
                return False
            fn = getattr(self.actor_instance, spec.method_name, None)
            if fn is None or inspect.iscoroutinefunction(fn):
                return False
            self._caller_incarnation.setdefault(caller, spec.incarnation)
            group_seq[caller] = expected + (1 if spec.seq_no >= 0 else 0)
        elif spec.kind == pb.TASK_KIND_NORMAL:
            try:
                fn = await self.cw.fetch_function(spec.function_key)
            except BaseException:  # noqa: BLE001 — slow path reports it
                return False
            if inspect.iscoroutinefunction(fn):
                return False
        else:
            return False
        fut = asyncio.get_running_loop().create_future()
        self._in_flight[tid] = fut
        try:
            if spec.runtime_env:
                from ray_tpu_torch._private.runtime_env_mgr import setup_runtime_env

                await setup_runtime_env(spec.runtime_env, self.cw)
            args, kwargs = await self._resolve_args(spec.args)
            group.append((spec, fut, fn, args, kwargs, None))
        except BaseException as e:  # noqa: BLE001 — becomes an error reply
            group.append((spec, fut, None, None, None, e))
        return True

    async def _execute_fast_group(self, group: list) -> list:
        t0 = time.time()
        from ray_tpu_torch._private import hops

        hop_on = hops.enabled()

        def run_all():
            outs = []
            dequeues, fn_times = [], []
            for spec, _fut, fn, args, kwargs, prep_err in group:
                tid = spec.task_id.binary()
                if prep_err is not None:
                    outs.append((None, prep_err, None))
                    continue
                if tid in self._cancelled:
                    outs.append((None, TaskCancelledError(
                        f"task {spec.name} was cancelled"), None))
                    continue
                # puts inside the fn derive ids from the current task
                self.cw.current_task_id = spec.task_id
                whop = None
                try:
                    rec = (self._record_span(spec) if spec.trace_ctx
                           else None)
                    if hop_on:
                        t_start_ns = time.monotonic_ns()
                        recv_ns = getattr(spec, "_recv_ns", None)
                        if recv_ns is not None:
                            dequeues.append(t_start_ns - recv_ns)
                        whop = {"recv": getattr(spec, "_recv_wall", 0.0),
                                "start": time.time()}
                    with execution_span(spec, rec):
                        result = self._call_traced(tid, fn, *args, **kwargs)
                    if hop_on:
                        t_end_ns = time.monotonic_ns()
                        fn_times.append(t_end_ns - t_start_ns)
                        whop["end"] = time.time()
                    outs.append((result, None, whop))
                except BaseException as e:  # noqa: BLE001 — per-task error
                    outs.append((None, e, whop))
            if dequeues:
                hops.observe_many_ns("exec_dequeue", dequeues)
            if fn_times:
                hops.observe_many_ns("user_fn", fn_times)
            return outs

        try:
            outs = await asyncio.get_running_loop().run_in_executor(
                self.thread_pool, run_all)
        except BaseException as e:  # noqa: BLE001 — pool torn down
            for spec, fut, *_ in group:
                self._in_flight.pop(spec.task_id.binary(), None)
                if not fut.done():
                    fut.set_exception(e)
                    fut.exception()
            raise
        replies = []
        for (spec, fut, *_rest), (result, err, whop) in zip(group, outs):
            tid = spec.task_id.binary()
            if err is None:
                try:
                    reply = await self._returns_reply(spec, result)
                except BaseException as e:  # noqa: BLE001
                    reply = self._error_reply(spec, e)
            else:
                reply = self._error_reply(spec, err)
            if whop is not None and isinstance(spec.trace_ctx, dict) \
                    and spec.trace_ctx.get("trace_id"):
                # explicit traces get per-task wall stamps in the reply so
                # the owner can render the call's hop spans on the timeline
                reply["hops"] = whop
            self._in_flight.pop(tid, None)
            self._cancelled.discard(tid)
            if spec.kind == pb.TASK_KIND_ACTOR_TASK:
                # mirror the slow path: advance the caller's sequence window
                # and cache the reply for duplicate deliveries
                self._advance(spec.owner_worker_id, spec.seq_no,
                              spec.incarnation)
                self._reply_cache[tid] = reply
                while len(self._reply_cache) > 1024:
                    self._reply_cache.popitem(last=False)
            if not fut.done():
                fut.set_result(reply)
            self.cw.task_events.record(
                task_id=tid,
                name=spec.name or spec.method_name or spec.function_key,
                kind=spec.kind,
                event="FAILED" if reply.get("error") else "FINISHED",
                worker_id=self.cw.worker_id.binary(),
                node_id=self.cw.node_id_hex or "",
                duration_s=(time.time() - t0) / max(1, len(group)),
            )
            replies.append(reply)
        return replies

    # ------------------------------------------------------------------

    async def _resolve_args(self, wire_args) -> Tuple[tuple, dict]:
        if not wire_args:
            return (), {}
        resolved = await self.cw.resolve_args_batch(wire_args)
        args, kwargs = [], {}
        for wire, value in zip(wire_args, resolved):
            if wire.get("kw") is not None:
                kwargs[wire["kw"]] = value
            else:
                args.append(value)
        return tuple(args), kwargs

    def _error_reply(self, spec: pb.TaskSpec, exc: BaseException) -> dict:
        if isinstance(exc, TaskCancelledError):
            # system error: surfaces directly at get(), not wrapped in
            # TaskError (reference: TaskCancelledError in ray.exceptions)
            return {"error": {
                "traceback": "", "pickled": ser.serialize(exc).to_bytes(),
            }}
        terr = TaskError.from_exception(spec.name or spec.method_name or spec.function_key, exc)
        try:
            pickled = ser.serialize(terr).to_bytes()
        except Exception:  # noqa: BLE001 — unpicklable cause
            pickled = ser.serialize(
                TaskError(terr.function_name, terr.traceback_str)
            ).to_bytes()
        return {"error": {"traceback": terr.traceback_str, "pickled": pickled}}

    async def _returns_reply(self, spec: pb.TaskSpec, result: Any) -> dict:
        oids = spec.return_ids()
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"task declared num_returns={spec.num_returns} but returned "
                    f"{len(values)} values"
                )
        returns = []
        for oid, value in zip(oids, values):
            sobj = ser.serialize(value)
            returns.append(await self.cw.store_return(oid, sobj, META_NORMAL))
        return {"returns": returns}

    async def _execute_normal(self, spec: pb.TaskSpec) -> dict:
        tid = spec.task_id.binary()
        try:
            if tid in self._cancelled:
                raise TaskCancelledError(f"task {spec.name} was cancelled")
            # runtime env (env_vars e.g. MEGASCALE_*, working_dir,
            # py_modules) applies BEFORE the function/args deserialize —
            # unpickling may reference modules the env ships (reference: the
            # runtime-env agent builds the env, the worker execs inside it)
            from ray_tpu_torch._private.runtime_env_mgr import setup_runtime_env

            await setup_runtime_env(spec.runtime_env, self.cw)
            fn = await self.cw.fetch_function(spec.function_key)
            args, kwargs = await self._resolve_args(spec.args)
            self.cw.current_task_id = spec.task_id
            rec = self._record_span(spec) if spec.trace_ctx else None
            from ray_tpu_torch._private import hops

            whop = None
            if hops.enabled():
                t_start = time.monotonic_ns()
                recv_ns = getattr(spec, "_recv_ns", None)
                if recv_ns is not None:
                    hops.observe_ns("exec_dequeue", t_start - recv_ns)
                whop = {"recv": getattr(spec, "_recv_wall", 0.0),
                        "start": time.time()}
            with execution_span(spec, rec) as span:
                if span is not None and not inspect.iscoroutinefunction(fn):
                    fn = bind_span(fn, span)
                result = await self._invoke(tid, fn, args, kwargs)
                if spec.is_streaming:
                    # the generator body runs during iteration (on pool
                    # threads): the span must cover it, not just
                    # construction
                    if span is not None and inspect.isgenerator(result):
                        result = bind_generator(result, span)
                    return await self._stream_out(spec, result)
            if whop is not None:
                whop["end"] = time.time()
                hops.observe_ns("user_fn", time.monotonic_ns() - t_start)
            reply = await self._returns_reply(spec, result)
            if whop is not None and isinstance(spec.trace_ctx, dict) \
                    and spec.trace_ctx.get("trace_id"):
                reply["hops"] = whop
            return reply
        except BaseException as e:  # noqa: BLE001 — all errors cross the wire
            return self._error_reply(spec, e)

    async def _invoke(self, tid: bytes, fn, args, kwargs, pool=None) -> Any:
        """Call the user function with cancellation hooks installed; sync
        functions run on `pool` (a concurrency group's lane) or the default
        actor thread pool."""
        if inspect.iscoroutinefunction(fn):
            atask = asyncio.ensure_future(fn(*args, **kwargs))
            self._running_atasks[tid] = atask
            try:
                return await atask
            except asyncio.CancelledError:
                if tid in self._cancelled:
                    raise TaskCancelledError("task was cancelled") from None
                raise
            finally:
                self._running_atasks.pop(tid, None)
        return await asyncio.get_running_loop().run_in_executor(
            pool if pool is not None else self.thread_pool,
            lambda: self._call_traced(tid, fn, *args, **kwargs),
        )

    async def _execute_actor_creation(self, spec: pb.TaskSpec) -> dict:
        try:
            from ray_tpu_torch._private.runtime_env_mgr import setup_runtime_env

            # actor workers are dedicated to this env for their lifetime
            await setup_runtime_env(spec.runtime_env, self.cw, dedicated=True)
            cls = await self.cw.fetch_function(spec.function_key)
            args, kwargs = await self._resolve_args(spec.args)
            self.actor_spec = spec
            self.cw.current_task_id = spec.task_id
            if spec.max_concurrency > 1 and not spec.is_async_actor:
                self.thread_pool = ThreadPoolExecutor(
                    max_workers=spec.max_concurrency, thread_name_prefix="actor-exec"
                )
            if spec.is_async_actor:
                self._actor_sem = asyncio.Semaphore(max(1, spec.max_concurrency))
            # named concurrency groups (reference: concurrency_group_manager.h):
            # each group gets its own executor lane so one group saturating
            # (or blocking) never starves another
            for gname, gmax in (spec.concurrency_groups or {}).items():
                if spec.is_async_actor:
                    self._group_sems[gname] = asyncio.Semaphore(max(1, gmax))
                else:
                    self._group_pools[gname] = ThreadPoolExecutor(
                        max_workers=max(1, gmax),
                        thread_name_prefix=f"actor-cg-{gname}",
                    )
            rec = self._record_span(spec) if spec.trace_ctx else None
            with execution_span(spec, rec) as span:
                ctor = (lambda: cls(*args, **kwargs)) if span is None \
                    else bind_span(lambda: cls(*args, **kwargs), span)
                self.actor_instance = (
                    await asyncio.get_running_loop().run_in_executor(
                        self.thread_pool, ctor))
            return {"returns": []}
        except BaseException as e:  # noqa: BLE001
            return self._error_reply(spec, e)

    async def _execute_actor_task(self, spec: pb.TaskSpec) -> dict:
        caller = spec.owner_worker_id
        is_async = self.actor_spec is not None and self.actor_spec.is_async_actor
        threaded = self.actor_spec is not None and (
            self.actor_spec.max_concurrency > 1
            or bool(self.actor_spec.concurrency_groups)
        )
        if not is_async and not threaded:
            try:
                await self._wait_turn(caller, spec.seq_no, spec.incarnation)
            except asyncio.TimeoutError as e:
                # Never execute out of order: a hole in the sequence after the
                # timeout means the predecessor was lost for good (caller died
                # mid-retry); fail this task instead of corrupting actor-state
                # ordering (reference: SequentialActorSubmitQueue never
                # reorders). Acknowledge the hole as permanently lost so later
                # sequence numbers from this caller regain liveness.
                self._advance(caller, spec.seq_no, spec.incarnation)
                return self._error_reply(spec, e)
            except _StaleSequenceError as e:
                return self._error_reply(spec, e)
        try:
            if spec.cancelled:
                # tombstone for a task cancelled before delivery: consume the
                # sequence slot, never run the method
                return self._error_reply(spec, TaskCancelledError(
                    f"actor task {spec.method_name} was cancelled"))
            return await self._run_method(spec, is_async)
        finally:
            if not is_async and not threaded:
                self._advance(caller, spec.seq_no, spec.incarnation)

    async def _wait_turn(self, caller: bytes, seq: int, incarnation: int = 0):
        """Per-caller in-order execution (reference: sequential actor queues).

        Ordering holds within the newest caller incarnation. A task from an
        OLDER incarnation (a retry straddling an actor restart) runs
        unordered — its predecessors may have executed in a previous worker
        process, so there is nothing to wait for. A task from a NEWER
        incarnation resets the sequence window and releases stale waiters.
        """
        if seq < 0:
            return
        cur = self._caller_incarnation.setdefault(caller, incarnation)
        if incarnation < cur:
            return
        if incarnation > cur:
            self._caller_incarnation[caller] = incarnation
            self._expected_seq[caller] = 1
            for ev in self._buffered.get(caller, {}).values():
                ev.set()  # stale waiters from the old incarnation
        expected = self._expected_seq.setdefault(caller, 1)
        if seq == expected:
            return
        if seq < expected:
            # below the window with no cached reply: a predecessor already
            # declared lost (gap timeout advanced past it) or an expired
            # duplicate — running it now would reorder state mutations
            raise _StaleSequenceError(
                f"ordered actor task seq={seq} is below the current window "
                f"(expected seq={expected}); predecessor slot already "
                f"abandoned or reply cache expired"
            )
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        event = asyncio.Event()
        self._buffered.setdefault(caller, {})[seq] = event
        try:
            await asyncio.wait_for(
                event.wait(),
                timeout=GLOBAL_CONFIG.get("actor_ordering_gap_timeout_s"),
            )
        except asyncio.TimeoutError:
            raise asyncio.TimeoutError(
                f"ordered actor task seq={seq} timed out waiting for missing "
                f"predecessor (expected seq={self._expected_seq.get(caller)})"
            ) from None
        finally:
            self._buffered.get(caller, {}).pop(seq, None)

    def _advance(self, caller: bytes, seq: int, incarnation: int = 0):
        if seq < 0:
            return
        # a finishing task from an older incarnation must not move the new
        # incarnation's sequence window
        if incarnation != self._caller_incarnation.get(caller, incarnation):
            return
        nxt = max(self._expected_seq.get(caller, 1), seq + 1)
        self._expected_seq[caller] = nxt
        buf = self._buffered.get(caller, {})
        if nxt in buf:
            buf[nxt].set()

    async def _run_method(self, spec: pb.TaskSpec, is_async: bool) -> dict:
        tid = spec.task_id.binary()
        try:
            if self.actor_instance is None:
                raise RuntimeError("actor instance not initialized")
            if tid in self._cancelled:
                raise TaskCancelledError(f"actor task {spec.method_name} was cancelled")
            args, kwargs = await self._resolve_args(spec.args)
            if spec.method_name == "__rt_call__":
                # system method (reference: actor.__ray_call__): args[0] is
                # a function executed as fn(actor_instance, *rest) inside
                # the actor process — the compiled-DAG executor loop rides
                # this without requiring methods on the user's class
                import functools as _ft

                method = _ft.partial(args[0], self.actor_instance)
                args = tuple(args[1:])
            else:
                method = getattr(self.actor_instance, spec.method_name)
            self.cw.current_task_id = spec.task_id
            group = spec.concurrency_group
            declared = (self.actor_spec.concurrency_groups or {}
                        if self.actor_spec else {})
            if group and group not in declared:
                raise ValueError(
                    f"method {spec.method_name!r} submitted with undeclared "
                    f"concurrency group {group!r} (declared: "
                    f"{sorted(declared) or 'none'})"
                )
            rec = self._record_span(spec) if spec.trace_ctx else None
            with execution_span(spec, rec) as span:
                if span is not None and not inspect.iscoroutinefunction(
                        method):
                    method = bind_span(method, span)
                if is_async:
                    sem = self._group_sems.get(group, self._actor_sem)
                    async with sem:
                        if inspect.iscoroutinefunction(method):
                            result = await self._invoke(
                                tid, method, args, kwargs)
                        else:
                            result = method(*args, **kwargs)
                else:
                    result = await self._invoke(
                        tid, method, args, kwargs,
                        pool=self._group_pools.get(group),
                    )
                if spec.is_streaming:
                    if span is not None and inspect.isgenerator(result):
                        result = bind_generator(result, span)
                    return await self._stream_out(spec, result)
            return await self._returns_reply(spec, result)
        except BaseException as e:  # noqa: BLE001
            return self._error_reply(spec, e)

    # ------------------------------------------------------------------
    # streaming generators — executor side (reference: _raylet.pyx
    # execute_streaming_generator + ReportGeneratorItemReturns RPCs)
    # ------------------------------------------------------------------

    async def _stream_out(self, spec: pb.TaskSpec, result: Any) -> dict:
        """Drive a generator result, reporting each item to the owner in
        order. Backpressure: pause when more than spec.stream_backpressure
        items are unconsumed. A mid-generator exception (including
        cancellation) becomes an error reply; the owner appends it as the
        stream's final errored item."""
        tid = spec.task_id.binary()
        is_agen = inspect.isasyncgen(result)
        if not is_agen and not inspect.isgenerator(result):
            result = iter([result])  # plain value: one-item stream
        client = await self.cw._owner_client(spec.owner_address)
        loop = asyncio.get_running_loop()
        idx = 0
        bp = spec.stream_backpressure
        try:
            while True:
                if tid in self._cancelled:
                    raise TaskCancelledError(f"task {spec.name} was cancelled")
                if is_agen:
                    # register the item fetch so cancel() can interrupt an
                    # await inside the user's async generator body
                    atask = asyncio.ensure_future(result.__anext__())
                    self._running_atasks[tid] = atask
                    try:
                        item = await atask
                    except StopAsyncIteration:
                        break
                    except asyncio.CancelledError:
                        if tid in self._cancelled:
                            raise TaskCancelledError(
                                f"task {spec.name} was cancelled") from None
                        raise
                    finally:
                        self._running_atasks.pop(tid, None)
                else:
                    item = await loop.run_in_executor(
                        self.thread_pool,
                        lambda: self._call_traced(tid, self._next_or_end, result),
                    )
                    if item is _STREAM_END:
                        break
                sobj = ser.serialize(item)
                oid = ObjectID.for_task_return(spec.task_id, idx)
                ret = await self.cw.store_return(oid, sobj, META_NORMAL)
                reply = await client.call(
                    "report_stream_item",
                    {"task_id": tid, "index": idx, "ret": ret},
                    timeout=None,
                )
                idx += 1
                if reply.get("cancelled"):
                    raise TaskCancelledError(f"stream {spec.name} was dropped")
                if bp > 0 and idx - reply.get("consumed", 0) >= bp:
                    r2 = await client.call(
                        "stream_wait_consumed",
                        {"task_id": tid, "until": idx - bp + 1},
                        timeout=None,
                    )
                    if r2.get("cancelled"):
                        raise TaskCancelledError(f"stream {spec.name} was dropped")
            return {"returns": [], "stream_end": idx}
        except BaseException as e:  # noqa: BLE001 — becomes the final errored item
            if is_agen:
                try:
                    await result.aclose()
                except Exception:  # noqa: BLE001
                    pass
            else:
                result.close()
            return self._error_reply(spec, e)

    @staticmethod
    def _next_or_end(gen):
        try:
            return next(gen)
        except StopIteration:
            return _STREAM_END
