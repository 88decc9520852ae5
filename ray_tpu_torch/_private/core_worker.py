"""Core worker — the per-process task/actor/object runtime.

Capability parity with the reference's core worker (reference:
src/ray/core_worker/core_worker.h:182 — SubmitTask core_worker.cc:1995,
Get :1326, HandlePushTask :3672; task_submission/normal_task_submitter.h:87;
task_submission/actor_task_submitter.h:69; store_provider/memory_store/
memory_store.h:48; reference_counter.h:44). Linked into every driver and
worker process; drivers run it on a background asyncio thread, workers run it
on the process main loop.

Data plane design: small objects ride RPC replies into the owner's in-process
memory store; large objects are sealed into the executing node's shared-memory
store and the owner records the location (ownership-based object directory,
reference: ownership_object_directory.h). `get` of a remote object asks the
local daemon to pull it chunk-wise into the local store, then maps it
zero-copy.
"""

from __future__ import annotations

import asyncio
import collections
from ray_tpu_torch._private.aio import spawn
import functools
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch._private import fastpath as _fp
from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private import hops
from ray_tpu_torch._private import protocol as pb
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.errors import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    ObjectStoreFullError,
    RayTpuError,
    RpcError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.protocol import ResourceSet, SchedulingStrategy, TaskSpec
from ray_tpu_torch.runtime.object_store import META_ERROR, META_NORMAL, ShmObjectStore
from ray_tpu_torch.runtime.rpc import RpcClient, RpcConnectionLost, RpcServer

logger = logging.getLogger(__name__)


def _trace_inject():
    """Outgoing trace context (None when tracing is off — the common case
    costs one function call and an env lookup)."""
    from ray_tpu_torch.util.tracing import inject_context

    return inject_context()


_DERIVE_CTX_CACHE = None


def _tracing_DERIVE_CTX():
    # cached: this sits on the traced fast-lane eligibility check
    global _DERIVE_CTX_CACHE
    if _DERIVE_CTX_CACHE is None:
        from ray_tpu_torch.util.tracing import DERIVE_CTX

        _DERIVE_CTX_CACHE = DERIVE_CTX
    return _DERIVE_CTX_CACHE

MODE_DRIVER = "driver"
MODE_WORKER = "worker"

_FP_EMPTY_ARGS = b"\x90"  # msgpack []


def _fp_pack_args(wire_args: list) -> bytes:
    """Wire args as one msgpack value for the native spec encoder (fast-lane
    args are inline-only entries, typically tiny)."""
    if not wire_args:
        return _FP_EMPTY_ARGS
    import msgpack

    return msgpack.packb(wire_args, use_bin_type=True)

_current_core_worker: Optional["CoreWorker"] = None


def get_core_worker() -> "CoreWorker":
    if _current_core_worker is None:
        raise RayTpuError("ray_tpu_torch.init() has not been called in this process")
    return _current_core_worker


def set_core_worker(cw: Optional["CoreWorker"]) -> None:
    global _current_core_worker
    _current_core_worker = cw


def compute_lease_key(resources: "ResourceSet", strategy,
                      env_key: str = "") -> Optional[tuple]:
    """Scheduling key: tasks of the same shape can reuse one lease
    (reference: normal_task_submitter.h SchedulingKey lease pools —
    including the runtime-env hash: an env-isolated worker must never
    serve another env's tasks). None → never pool: SPREAD tasks must
    spread across nodes, and reusing one granted worker would pin them."""
    if strategy.kind == pb.STRATEGY_SPREAD:
        return None
    return (
        tuple(sorted(resources.to_wire().items())),
        tuple(sorted(
            (k, str(v)) for k, v in strategy.to_wire().items()
        )),
        env_key,
    )


class ObjectRef:
    """A reference to a (possibly not-yet-computed) remote object.

    Reference: the ObjectRef/ObjectID surface of python/ray/_raylet.pyx and
    the distributed ref counting of src/ray/core_worker/reference_counter.h:44.
    Pickling an ObjectRef registers a borrow with the owner; dropping the last
    reference in a process releases it.
    """

    __slots__ = ("_id", "_owner_address", "_owner_worker_id", "_released", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_address: str, owner_worker_id: bytes,
                 *, _register: bool = True):
        self._id = object_id
        self._owner_address = owner_address
        self._owner_worker_id = owner_worker_id
        self._released = False
        if _register and _current_core_worker is not None:
            _current_core_worker.ref_counter.add_local(self)

    def object_id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    @property
    def owner_address(self) -> str:
        return self._owner_address

    def __reduce__(self):
        ser.note_contained_ref(self)
        return (
            _deserialize_object_ref,
            (self._id.binary(), self._owner_address, self._owner_worker_id),
        )

    def __del__(self):
        # A finaliser may run inside any allocation of any thread, even one
        # made while that thread holds the reference counter's lock: it only
        # hands the release over (ReferenceCounter.release_deferred).
        if not self._released and _current_core_worker is not None:
            self._released = True
            try:
                _current_core_worker.ref_counter.release_deferred(
                    self._id.binary(), self._owner_worker_id)
            except Exception:  # noqa: BLE001 — interpreter shutdown
                pass

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    # Allow `await ref` inside async actors.
    def __await__(self):
        cw = get_core_worker()
        return cw.get_async(self).__await__()


def _deserialize_object_ref(id_bytes: bytes, owner_address: str, owner_worker_id: bytes):
    ref = ObjectRef(ObjectID(id_bytes), owner_address, owner_worker_id, _register=False)
    if _current_core_worker is not None:
        _current_core_worker.ref_counter.on_ref_deserialized(ref)
    return ref


class ReferenceCounter:
    """Tracks local reference counts and cross-process borrows.

    Reference: src/ray/core_worker/reference_counter.h:44. Owned objects are
    freed when (local refs == 0) and (known borrowers == 0); borrower
    processes notify the owner on first deserialization and on release.

    Borrows are TRANSITIVE BY CONSTRUCTION: a ref forwarded B -> C makes C
    register with the OWNER directly (the owner address rides inside every
    serialized ref), so chained borrowers need no per-hop protocol — the
    piece of the reference's 2.6k-line borrow machinery that exists to
    merge borrower lists up the chain is structural here. The no-premature-
    free invariant across the forwarding window holds because the
    forwarding task's submission pins the ref (serialize_args `_pyref`)
    until the task completed, which is after the receiver registered.

    Owner-side borrows are keyed by borrower ADDRESS so borrows held by
    DEAD borrower processes can be reconciled: a borrower that dies
    without remove_borrow would otherwise pin the object forever
    (reference: reference_counter borrower-death cleanup via pubsub;
    here a slow reaper probes borrower liveness over the RPC plane).

    No finaliser blocks here. ``ObjectRef.__del__``, which the cyclic GC
    may run inside any allocation (one made while this thread holds the
    lock included), takes no lock: ``release_deferred`` appends to a deque,
    and the next add, or a drain queued on the worker's loop, applies the
    release. Each key is taken before the lock, so no call under it runs a
    ref's own code."""

    def __init__(self, cw: "CoreWorker"):
        self.cw = cw
        self.local_counts: Dict[bytes, int] = {}
        # owned objects: oid -> {borrower_address: count}
        self.borrower_counts: Dict[bytes, Dict[str, int]] = {}
        self.borrowed_owners: Dict[bytes, str] = {}  # oid -> owner address
        self._lock = threading.Lock()
        # (key, owner worker id) released by finalisers, not yet applied
        self._deferred: collections.deque = collections.deque()
        self._drain_queued = False

    def add_local(self, ref: ObjectRef):
        key = ref.binary()
        with self._lock:
            self.local_counts[key] = self.local_counts.get(key, 0) + 1
        self.drain()

    def release_deferred(self, key: bytes, owner_worker_id: bytes):
        """The finaliser's half of a release: a deque append (atomic, no
        lock) and a drain queued on the loop. Never blocks."""
        self._deferred.append((key, owner_worker_id))
        if not self._drain_queued:
            self._drain_queued = True
            try:
                self.cw.loop.call_soon_threadsafe(self.drain)
            except RuntimeError:  # the loop is closed: shutdown
                self._drain_queued = False

    def drain(self):
        """Apply the releases finalisers handed over. Called outside the
        lock, from ordinary code only."""
        self._drain_queued = False
        while True:
            try:
                key, owner_worker_id = self._deferred.popleft()
            except IndexError:
                return
            with self._lock:
                n = self.local_counts.get(key, 0) - 1
                if n > 0:
                    self.local_counts[key] = n
                    continue
                self.local_counts.pop(key, None)
            self.cw.schedule(self._on_zero_local(key, owner_worker_id))

    async def _on_zero_local(self, key: bytes, owner_worker_id: bytes):
        with self._lock:
            if self.local_counts.get(key, 0) > 0:
                return
        if owner_worker_id == self.cw.worker_id.binary():
            with self._lock:
                if self.borrower_counts.get(key):
                    return
            await self.cw.free_owned_object(ObjectID(key))
        else:
            owner = self.borrowed_owners.pop(key, None)
            if owner:
                await self.cw.notify_owner(owner, "remove_borrow", key)

    def on_ref_deserialized(self, ref: ObjectRef):
        """First sight of a borrowed ref in this process."""
        key = ref.binary()
        with self._lock:
            first = key not in self.local_counts
            self.local_counts[key] = self.local_counts.get(key, 0) + 1
        self.drain()
        if not self.cw.owns(ref) and first:
            self.borrowed_owners[ref.binary()] = ref.owner_address
            self.cw.schedule(
                self.cw.notify_owner(ref.owner_address, "add_borrow", ref.binary())
            )

    # owner side
    def add_borrower(self, oid: bytes, borrower: str = ""):
        with self._lock:
            per = self.borrower_counts.setdefault(oid, {})
            per[borrower] = per.get(borrower, 0) + 1

    def remove_borrower(self, oid: bytes, borrower: str = ""):
        drop = False
        with self._lock:
            per = self.borrower_counts.get(oid)
            if per is None:
                return
            n = per.get(borrower, 0) - 1
            if n <= 0:
                per.pop(borrower, None)
            else:
                per[borrower] = n
            if not per:
                self.borrower_counts.pop(oid, None)
                drop = self.local_counts.get(oid, 0) == 0
        if drop:
            self.cw.schedule(self.cw.free_owned_object(ObjectID(oid)))

    def drop_borrower_process(self, borrower: str) -> int:
        """Reconcile every borrow held by a (dead) borrower process; frees
        objects whose last reference that was. Returns how many borrows
        were dropped."""
        to_free = []
        dropped = 0
        with self._lock:
            for oid in list(self.borrower_counts):
                per = self.borrower_counts[oid]
                if borrower in per:
                    dropped += per.pop(borrower)
                    if not per:
                        self.borrower_counts.pop(oid, None)
                        if self.local_counts.get(oid, 0) == 0:
                            to_free.append(oid)
        for oid in to_free:
            self.cw.schedule(self.cw.free_owned_object(ObjectID(oid)))
        return dropped

    def borrower_addresses(self) -> set:
        with self._lock:
            return {b for per in self.borrower_counts.values() for b in per}


class MemoryStore:
    """In-process store for small owned objects and pending futures.

    Reference: src/ray/core_worker/store_provider/memory_store/memory_store.h:48.
    Values are kept serialized (bytes, metadata); futures resolve when a task
    reply or put lands.
    """

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self.objects: Dict[bytes, Tuple[bytes, int]] = {}
        self.locations: Dict[bytes, dict] = {}  # oid -> {"daemon": addr, "node_id": hex}
        self.futures: Dict[bytes, List[asyncio.Future]] = {}

    def put(self, oid: bytes, data: bytes, meta: int):
        self.objects[oid] = (data, meta)
        for fut in self.futures.pop(oid, []):
            if not fut.done():
                fut.set_result(True)

    def set_location(self, oid: bytes, location: dict):
        self.locations[oid] = location
        for fut in self.futures.pop(oid, []):
            if not fut.done():
                fut.set_result(True)

    def fail(self, oid: bytes, exc: Exception):
        data = ser.serialize(exc).to_bytes()
        self.put(oid, data, META_ERROR)

    def contains(self, oid: bytes) -> bool:
        return oid in self.objects or oid in self.locations

    def wait_future(self, oid: bytes) -> asyncio.Future:
        fut = self.loop.create_future()
        if self.contains(oid):
            fut.set_result(True)
        else:
            self.futures.setdefault(oid, []).append(fut)
        return fut

    def delete(self, oid: bytes):
        self.objects.pop(oid, None)
        self.locations.pop(oid, None)


class StreamState:
    """Owner-side state of one streaming-generator task (reference:
    src/ray/core_worker/task_manager.h:88 ObjectRefStream).

    The executor reports items strictly in order (it awaits each report ack),
    so `produced` is a contiguous count. `consumed` advances as the user's
    iterator takes refs; the executor blocks when produced - consumed exceeds
    the task's backpressure threshold."""

    __slots__ = ("task_id", "produced", "consumed", "next_read", "end",
                 "waiters", "consume_waiters", "cancelled")

    def __init__(self, task_id: bytes):
        self.task_id = task_id
        self.produced = 0
        self.consumed = 0
        self.next_read = 0
        self.end: Optional[int] = None
        self.waiters: List[asyncio.Future] = []     # item-available / end
        self.consume_waiters: List[Tuple[int, asyncio.Future]] = []
        self.cancelled = False

    def wake_all(self):
        for fut in self.waiters:
            if not fut.done():
                fut.set_result(True)
        self.waiters.clear()

    def wake_consumers(self, force: bool = False):
        keep = []
        for until, fut in self.consume_waiters:
            if force or self.consumed >= until or self.cancelled or self.end is not None:
                if not fut.done():
                    fut.set_result(True)
            else:
                keep.append((until, fut))
        self.consume_waiters = keep


class ObjectRefGenerator:
    """Iterator over the return refs of a `num_returns="streaming"` task.

    Reference: python/ray/_raylet.pyx ObjectRefGenerator. Sync iteration from
    driver threads; async iteration inside async actors. Dropping the
    generator cancels the producer and frees unconsumed items. Not
    serializable — consume it in the owning process."""

    def __init__(self, cw: "CoreWorker", task_id: bytes):
        self._cw = cw
        self._task_id = task_id

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        ref = self._cw.run_sync(self._cw.stream_next(self._task_id))
        if ref is None:
            raise StopIteration
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        ref = await self._cw.stream_next(self._task_id)
        if ref is None:
            raise StopAsyncIteration
        return ref

    def completed(self) -> bool:
        st = self._cw._streams.get(self._task_id)
        return st is None or (st.end is not None and st.next_read >= st.end)

    def __reduce__(self):
        raise TypeError(
            "ObjectRefGenerator is not serializable; iterate it in the "
            "process that created it"
        )

    def __del__(self):
        cw = self._cw
        if cw is not None and not cw._closed and self._task_id in cw._streams:
            try:
                cw.schedule(cw.stream_drop(self._task_id))
            except Exception:  # noqa: BLE001 — interpreter shutdown
                pass


class _ActorRestartedWhileQueued(Exception):
    """Raised out of _await_push_turn when the actor's incarnation advanced
    while this spec was parked: it must be restamped, not pushed stale."""


class ActorHandleState:
    """Caller-side per-actor submission state (reference:
    actor_task_submitter.h:69 — ordered sequence numbers, address cache)."""

    __slots__ = ("actor_id", "seq", "address", "client", "state", "death_cause",
                 "event", "creation_keepalive", "incarnation", "ever_alive",
                 "push_queue", "pump_running", "push_next", "push_incarnation",
                 "push_waiters", "concurrent", "applied_version")

    def __init__(self, actor_id: bytes):
        self.actor_id = actor_id
        self.seq = 0
        # last applied (num_restarts, state-rank) version: state updates
        # arrive over BOTH pubsub and get_actor_info polls, whose replies
        # can reorder under load — a stale RESTARTING applied after the
        # fresh ALIVE would bump the incarnation spuriously and reset seq
        # numbering into the executor's duplicate-reply cache (found by the
        # chaos harness: two distinct calls returning one cached result)
        self.applied_version: tuple = (-1, -1)
        # push coalescing: (spec, future) entries drained by one pump task
        # into push_task_batch RPCs (reference: pipelined actor PushTask)
        self.push_queue: collections.deque = collections.deque()
        self.pump_running = False
        # in-order push release (reference: SequentialActorSubmitQueue sends
        # in sequence order): seq k+1 is never handed to the pump before k
        # was pushed or terminally failed, so the executor's reorder buffer
        # only ever spans in-flight deliveries — an args-gated predecessor
        # (upstream still computing in an actor DAG) can take arbitrarily
        # long without tripping the executor's lost-predecessor timeout.
        self.push_next = 1
        self.push_incarnation = 0
        self.push_waiters: Dict[int, asyncio.Future] = {}
        # async/threaded/concurrency-group actor: executions overlap on the
        # worker, so replies must not be coupled into batched pushes
        self.concurrent = False
        # bumped on every ALIVE transition to a replacement worker; per-
        # incarnation seq numbering restarts at 1 (reference: restart epoch
        # in actor_task_submitter.h). The first ALIVE keeps incarnation 0 so
        # tasks submitted while the actor was still PENDING stay ordered.
        self.incarnation = 0
        self.ever_alive = False
        self.address = ""
        self.client: Optional[RpcClient] = None
        self.state = pb.ACTOR_PENDING
        self.death_cause = ""
        self.event: Optional[asyncio.Event] = None
        # Pins ObjectRefs for constructor args promoted to the object store:
        # restarts re-resolve the creation args, so these live until the
        # actor is terminally DEAD (dropping the last ref earlier would free
        # the owned object and hang the actor's __init__).
        self.creation_keepalive: list = []


class CoreWorker:
    """The runtime: owns RPC endpoints, stores, submitters, and executors."""

    def __init__(
        self,
        mode: str,
        control_address: str,
        daemon_address: str,
        store_name: str,
        node_id_hex: str,
        job_id: JobID,
        loop: asyncio.AbstractEventLoop,
        worker_id: Optional[WorkerID] = None,
    ):
        self.mode = mode
        self.loop = loop
        # resolved lazily: the loop may not be running yet; compared by
        # thread id because asyncio.get_running_loop() throws (expensively)
        # on every non-loop-thread call
        self._loop_thread_id: Optional[int] = None
        self.job_id = job_id
        self.worker_id = worker_id or WorkerID.from_random()
        self.node_id_hex = node_id_hex
        self.control_address = control_address
        self.daemon_address = daemon_address
        # store_name=None → remote-client mode (reference: Ray Client,
        # python/ray/util/client): a driver with no host shm store; object
        # reads/writes ride daemon RPCs instead of mmap. Everything else
        # (tasks, actors, ownership, PGs) is the normal driver path.
        self.store = ShmObjectStore(store_name) if store_name else None
        self.store_name = store_name
        self.control = RpcClient(control_address, name=f"{mode}->cs")
        self.daemon = RpcClient(daemon_address, name=f"{mode}->daemon")
        self.server = RpcServer(name=f"{mode}-{self.worker_id.hex()[:6]}")
        self.address: str = ""
        self.memory_store = MemoryStore(loop)
        self.ref_counter = ReferenceCounter(self)
        self.current_task_id = TaskID.for_driver(job_id)
        self._task_index = 0
        self._put_index = 0
        self._actor_index = 0
        self._lock = threading.Lock()
        # submitter state
        self._streams: Dict[bytes, StreamState] = {}
        # task-id -> {"state", "worker", "cancelled", "atask", "return_oids",
        # "spec"} for ray_tpu_torch.cancel (reference: normal_task_submitter
        # CancelTask / actor_task_submitter queued-task cancellation)
        self._submissions: Dict[bytes, dict] = {}
        self._return_to_task: Dict[bytes, bytes] = {}
        # recovery plane (reference: object_recovery_manager.h): lineage
        # cache + per-object recovery state machine, driven by authoritative
        # death notices from the control store (see _private.recovery)
        from ray_tpu_torch._private.recovery import ObjectRecoveryManager

        self.recovery = ObjectRecoveryManager(self)
        # external "nodes"-channel listeners (e.g. the elastic train
        # controller's resize triggers): called with every node notice
        # AFTER the worker's own handling; exceptions are swallowed so a
        # listener can never wedge recovery
        self._node_listeners: list = []
        # subscriber-side pubsub gap detection: channel -> last publish seq
        # seen (every control-store notice is stamped with _seq)
        self._channel_seq: Dict[str, Optional[int]] = {
            "nodes": None, "workers": None,
        }
        # node-table version cursor (scale plane): reconciles after a seq
        # gap — including IN-STREAM jumps from the store's bounded-backlog
        # shedding — pull get_nodes_delta(cursor) instead of the full table
        self._node_table_version = -1
        self._gap_reconcile_task = None
        # pre-gap cursor pinned at gap-detection time (the reconcile task
        # runs deferred; by then the cursor has advanced past the shed
        # window); also re-armed by gaps landing while a reconcile flies
        self._nodes_reconcile_from: Optional[int] = None
        # workers-channel version cursor: worker-death notices carry `_wv`
        # and reconcile via get_workers_delta(cursor) — the same versioned-
        # delta plane the node table rides (the legacy list_dead_workers
        # snapshot path is gone). Versions are persisted store-side, so the
        # cursor survives a control-store failover and the post-failover
        # reconcile replays exactly the missed deaths.
        self._worker_table_version = -1
        self._workers_reconcile_from: Optional[int] = None
        # granted-but-idle worker leases by scheduling key, reused by the
        # next same-shaped task (reference: normal_task_submitter lease
        # pools). Each entry: {"idle": [lease...], "waiters": deque[Future]}.
        # Released leases hand off DIRECTLY to a waiting submission —
        # parking while submissions queue at the daemon would deadlock
        # capacity behind the sweep period. Idle leases swept by
        # _lease_pool_sweep.
        self._lease_pools: Dict[tuple, dict] = {}
        # cross-thread submission handoff: driver-thread .remote() appends
        # here and wakes the loop once per burst, not once per task (each
        # call_soon_threadsafe pays a socketpair write)
        self._xthread_submits: collections.deque = collections.deque()
        self._xthread_scheduled = False
        # pipelined push batching (reference: normal_task_submitter.h:226):
        # ready specs queue per scheduling key; feeders drain the queue in
        # push_task_batch RPCs, one leased worker per feeder at a time
        self._push_queues: Dict[tuple, collections.deque] = {}
        self._push_feeders: Dict[tuple, int] = {}
        # native control-plane fast path (reference: the _raylet.pyx
        # submit_task seam): specs encode to wire msgpack in C++ on the
        # CALLER thread and ride a lock-free ring per scheduling key; the
        # feeders pop batches and ship one preassembled frame. None → the
        # pure-Python path above is the only path (no compiler, flag off).
        self._fastpath = _fp.new_engine()
        self._fp_rings: Dict[tuple, int] = {}
        self._fp_templates: Dict[tuple, int] = {}
        self._actor_states: Dict[bytes, ActorHandleState] = {}
        self._owned_actor_handles: Dict[bytes, int] = {}
        # actor ids released by ActorHandle finalisers, not yet applied
        self._released_handles: collections.deque = collections.deque()
        self._bg_futures: set = set()
        self._worker_clients: Dict[str, RpcClient] = {}
        self._owner_clients: Dict[str, RpcClient] = {}
        # compiled-graph channel plane: rings THIS process reads, exposed
        # for cross-node writers via rpc_chan_write (reference:
        # torch_tensor_accelerator_channel.py — remote channel endpoints)
        self._dag_channels: Dict[tuple, Any] = {}
        self._dag_channel_locks: Dict[tuple, Any] = {}
        self._dag_channel_seqs: Dict[tuple, int] = {}  # idempotency marks
        # executor state (workers only)
        self.executor: Optional["TaskExecutor"] = None
        self._function_cache: Dict[str, Any] = {}
        self._exported: set = set()
        self._inline_max = GLOBAL_CONFIG.get("inline_object_max_bytes")
        from ray_tpu_torch._private.task_events import TaskEventBuffer

        self.task_events = TaskEventBuffer()
        self._telemetry_task: Optional[asyncio.Task] = None
        self._closed = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self):
        self.server.register_service(self)
        self.address = await self.server.start()
        await self.control.connect()
        await self.daemon.connect()
        self.control.subscribe_channel("actors", self._on_actor_update)
        await self.control.call("subscribe", {"channel": "actors"})
        # authoritative failure notices (reference: GCS node/worker-failure
        # pubsub): node deaths drive the recovery manager — lost locations
        # are poisoned and recovery starts on the NOTICE, not on a getter
        # tripping over a stale location; worker deaths reconcile borrows
        # immediately instead of waiting out the reaper's probe cycle
        self.control.subscribe_channel("nodes", self._on_node_notice)
        self.control.subscribe_channel("workers", self._on_worker_notice)
        await self._subscribe_notices()
        # a restarted control store loses server-side subscription state;
        # on resubscribe the reply seq is compared against the last notice
        # we saw — a mismatch means deaths were published while we were
        # away (control-store failover window) and triggers a full
        # node/worker table reconcile instead of trusting the stream
        self.control.on_reconnect(
            lambda: self.control.call("subscribe", {"channel": "actors"})
        )
        self.control.on_reconnect(
            lambda: self._subscribe_notices(resync=True)
        )
        # announce this process's RPC address so owners' borrow reapers can
        # distinguish authoritative death from mere unresponsiveness
        # (reference: the GCS workers table; see _borrow_reaper_loop)
        await self._register_worker_liveness()
        self.control.on_reconnect(self._register_worker_liveness)
        self._telemetry_task = spawn(self._telemetry_loop())
        self._lease_sweep_task = spawn(self._lease_pool_sweep())
        self._borrow_reaper_task = spawn(self._borrow_reaper_loop())
        if self.mode == MODE_WORKER:
            # fate-share with the node daemon (reference: workers die with
            # their raylet — agent_manager/worker fate-sharing). An orphaned
            # worker that outlives its daemon would keep accepting pushes
            # and store returns into a store no daemon serves.
            self._fate_task = spawn(self._daemon_fate_watch())

    async def rpc_ping(self, conn_id: int, payload: dict) -> dict:
        return {"ok": True}

    async def rpc_dump_flight_recorder(self, conn_id: int, payload) -> dict:
        return flight_recorder.dump()

    async def rpc_chaos_set(self, conn_id: int, payload: dict) -> dict:
        """Chaos scenario hook (testing only): apply chaos/testing config
        flags to this worker/driver process at runtime."""
        from ray_tpu_torch._private import chaos as _chaos

        GLOBAL_CONFIG.apply_system_config(payload.get("config", {}))
        _chaos.reset()
        return {"ok": True, "role": _chaos.role()}

    def _note_channel_seq(self, channel: str, message: dict):
        seq = message.get("_seq")
        if seq is not None:
            last = self._channel_seq.get(channel)
            if last is not None and seq > last + 1:
                # in-stream publish gap: the store shed notices to us
                # (bounded per-subscriber backlog) — death records may be
                # among the missing, so reconcile now, not at reconnect
                logger.info("%s-channel in-stream gap (%d -> %d); "
                            "reconciling death records", channel, last, seq)
                if channel == "nodes":
                    # pin the reconcile cursor to the PRE-gap version NOW:
                    # the reconcile task runs deferred, and by then the
                    # gap-revealing notice's _v (past the shed window) has
                    # already advanced _node_table_version — a pull from
                    # there would replay nothing
                    if (self._nodes_reconcile_from is None
                            or self._node_table_version
                            < self._nodes_reconcile_from):
                        self._nodes_reconcile_from = self._node_table_version
                elif channel == "workers":
                    # same pre-gap floor pinning for the workers cursor
                    if (self._workers_reconcile_from is None
                            or self._worker_table_version
                            < self._workers_reconcile_from):
                        self._workers_reconcile_from = \
                            self._worker_table_version
                self._spawn_gap_reconcile()
            self._channel_seq[channel] = seq if last is None else max(last, seq)

    def _spawn_gap_reconcile(self) -> None:
        if (self._gap_reconcile_task is None
                or self._gap_reconcile_task.done()):
            self._gap_reconcile_task = spawn(self._reconcile_death_records())

    async def _subscribe_notices(self, resync: bool = False):
        """Subscribe to the node/worker death channels with gap detection:
        the subscribe reply carries each channel's current publish seq. On
        a reconnect whose seq doesn't match the last notice seen, a death
        published during the outage (control-store failover window) was
        silently lost — run a full node/worker table reconcile so borrows
        and recovery still trigger."""
        gap = False
        pending: Dict[str, int] = {}
        for channel in ("nodes", "workers"):
            # capture the cursor BEFORE the subscribe lands: the instant
            # the store-side subscription exists, stream notices can
            # max-advance the cursor past the missed window, and both the
            # version comparison and the reconcile's from-cursor pull
            # would go blind to the gap
            cursor = (self._node_table_version if channel == "nodes"
                      else self._worker_table_version)
            reply = await self.control.call("subscribe", {"channel": channel})
            server_seq = reply.get("seq")
            if server_seq is None:
                continue
            last = self._channel_seq.get(channel)
            # the ephemeral publish seq alone is NOT a sufficient
            # same-stream check: a failed-over store restarts its seq
            # counters, and if it published exactly as many notices as we
            # had seen, the counters COINCIDE while the content differs.
            # The persisted version cursor (resumed across failovers)
            # breaks the tie.
            version_moved = (reply.get("version") is not None
                             and reply["version"] != cursor)
            if resync and (server_seq != last or version_moved):
                gap = True
                if channel == "nodes":
                    if (self._nodes_reconcile_from is None
                            or cursor < self._nodes_reconcile_from):
                        self._nodes_reconcile_from = cursor
                else:
                    if (self._workers_reconcile_from is None
                            or cursor < self._workers_reconcile_from):
                        self._workers_reconcile_from = cursor
                logger.info(
                    "%s-channel gap detected (last seen %s, server at %s; "
                    "version %s vs cursor %s)",
                    channel, last, server_seq, reply.get("version"), cursor)
            pending[channel] = server_seq
        if resync:
            # failover telemetry: outage as this subscriber saw it, and
            # whether the reconnect landed on a NEW store incarnation (the
            # seq mismatch) rather than a TCP blip to the same one
            from ray_tpu_torch._private import store_ha

            outage = None
            if self.control.last_disconnect_ts is not None:
                outage = time.monotonic() - self.control.last_disconnect_ts
            store_ha.record_store_reconnect(
                "driver" if self.mode == MODE_DRIVER else "worker",
                outage, new_incarnation=gap)
        if gap and not await self._reconcile_death_records():
            # reconcile failed (store still mid-failover): keep the OLD
            # last-seen seqs so the next reconnect re-detects this gap —
            # advancing them now would mark the missed window as seen
            return
        self._channel_seq.update(pending)

    async def _reconcile_death_records(self) -> bool:
        """Replay the authoritative node/worker death tables through the
        same notice handlers the pubsub stream feeds (both are idempotent):
        nothing recorded during a subscription gap stays unseen. Loops
        while fresh gap signals land mid-flight — a reply generated before
        a second shed cannot contain it, and dropping that signal on the
        single-flight guard would lose the window permanently."""
        while True:
            floor = self._nodes_reconcile_from
            self._nodes_reconcile_from = None
            wfloor = self._workers_reconcile_from
            self._workers_reconcile_from = None
            try:
                if GLOBAL_CONFIG.get("node_table_delta_sync"):
                    # cursor pull: exactly the node mutations published
                    # since the pre-gap cursor (same wires the stream
                    # carries, expected-death replica maps included) —
                    # O(missed), not O(nodes)
                    reply = await self.control.call(
                        "get_nodes_delta",
                        {"cursor": floor if floor is not None
                         else self._node_table_version})
                    nodes = reply.get("updates") or reply.get("nodes") or []
                    version = reply.get("version")
                else:
                    nodes = (await self.control.call(
                        "get_all_nodes", {})).get("nodes", [])
                    version = None
                for nw in nodes:
                    self._apply_node_notice(nw)
                if version is not None:
                    # authoritative assignment AFTER the apply: brings the
                    # cursor back DOWN after a store restart's counter
                    # reset (the stream path's monotonic guard never would)
                    self._node_table_version = version
                # workers-channel cursor pull: the deaths published since
                # the pre-gap cursor, replayed through the stream handler
                # (idempotent; the _wv guard drops anything already seen)
                wreply = await self.control.call(
                    "get_workers_delta",
                    {"cursor": wfloor if wfloor is not None
                     else self._worker_table_version})
                dead = wreply.get("updates") or wreply.get("workers") or []
                for rec in dead:
                    self._apply_worker_notice(rec)
                wversion = wreply.get("version")
                if wversion is not None:
                    self._worker_table_version = wversion
                logger.info(
                    "reconciled death records after pubsub gap: %d node(s), "
                    "%d dead worker record(s)", len(nodes), len(dead))
            except Exception:  # noqa: BLE001 — control store mid-failover;
                # re-arm the pre-gap floors (stream notices will advance
                # the live cursors past the missed window, so a later
                # from-cursor pull would replay nothing) and let the next
                # reconnect/gap signal retry from them
                if floor is not None and (
                        self._nodes_reconcile_from is None
                        or floor < self._nodes_reconcile_from):
                    self._nodes_reconcile_from = floor
                if wfloor is not None and (
                        self._workers_reconcile_from is None
                        or wfloor < self._workers_reconcile_from):
                    self._workers_reconcile_from = wfloor
                logger.warning("death-record reconcile failed",
                               exc_info=True)
                return False
            if (self._nodes_reconcile_from is None
                    and self._workers_reconcile_from is None):
                return True

    def _on_node_notice(self, message: dict):
        """Control-store "nodes" pubsub: a DEAD notice is the authoritative
        recovery trigger — poison lost locations (or fail them over to the
        drain replicas carried on an EXPECTED death), kick eager recovery,
        and drop pooled leases/clients aimed at the dead daemon. A DRAINING
        notice reroutes future submissions away immediately so no task
        retry is burned against a node that will refuse the lease."""
        self._note_channel_seq("nodes", message)
        ver = message.get("_v")
        if ver is not None:
            if ver <= self._node_table_version:
                # stale replay: the store's coalescing window can deliver
                # a notice AFTER the reconcile reply that already covered
                # it. A restarted store's lower counter is reset by the
                # reconcile's authoritative post-apply assignment.
                return
            self._node_table_version = ver
        self._apply_node_notice(message)

    def _apply_node_notice(self, message: dict):
        self._fan_out_node_notice(message)
        state = message.get("state")
        daemon_addr = message.get("address", "")
        if state in (pb.NODE_DRAINING, pb.NODE_DEAD):
            flight_recorder.record(
                "node", state,
                node=(message.get("node_id") or b"").hex()[:12],
                expected=(message.get("death") or {}).get("expected"))
        if state == pb.NODE_DRAINING:
            if daemon_addr:
                # cached leases on the draining node would be refused (or
                # worse, accepted and then die at the deadline): reroute new
                # work now, let in-flight tasks finish there
                self._drop_pooled_leases_from(daemon_addr)
            return
        if state != pb.NODE_DEAD:
            return
        node_hex = NodeID(message["node_id"]).hex()
        death = message.get("death") or {}
        self.recovery.on_node_death(
            node_hex, daemon_addr,
            reason=death.get("reason", ""),
            expected=death.get("expected", False),
            replicas=message.get("replicas"),
        )
        if daemon_addr:
            # a cached lease on the dead node would push the next task (or a
            # recovery re-execution) into a store no daemon serves
            self._drop_pooled_leases_from(daemon_addr)

    def add_node_listener(self, cb) -> None:
        """Register a callback for every "nodes" pubsub notice (dict wire
        form). Used by the elastic train controller: a DRAINING notice is
        its shrink trigger, a registered-ALIVE notice its regrow trigger —
        event-driven instead of burning a node-table poll per tick."""
        self._node_listeners.append(cb)

    def remove_node_listener(self, cb) -> None:
        try:
            self._node_listeners.remove(cb)
        except ValueError:
            pass

    def _fan_out_node_notice(self, message: dict):
        for cb in list(self._node_listeners):
            try:
                cb(message)
            except Exception:  # noqa: BLE001 — listeners must never wedge
                logger.warning("node-notice listener failed", exc_info=True)

    def _on_worker_notice(self, message: dict):
        """Control-store "workers" pubsub: a recorded worker/driver death
        reconciles its borrows NOW (the probe-based reaper loop stays as
        the fallback for missed pushes)."""
        self._note_channel_seq("workers", message)
        ver = message.get("_wv")
        if ver is not None:
            if ver <= self._worker_table_version:
                # stale replay: the store's coalescing window can deliver a
                # notice AFTER the reconcile reply that already covered it.
                # A restarted-unpersisted store's lower counter is reset by
                # the reconcile's authoritative post-apply assignment.
                return
            self._worker_table_version = ver
        self._apply_worker_notice(message)

    def _apply_worker_notice(self, message: dict):
        ver = message.get("_wv")
        if ver is not None:
            self._worker_table_version = max(
                self._worker_table_version, ver)
        if not message.get("dead"):
            return
        addr = message.get("address", "")
        if not addr:
            return
        flight_recorder.record("worker", "death_notice", address=addr,
                               reason=message.get("reason") or "")
        dropped = self.ref_counter.drop_borrower_process(addr)
        if dropped:
            logger.info(
                "reaped %d borrow(s) held by dead borrower %s "
                "(authoritative death notice: %s)", dropped, addr,
                message.get("reason") or "unspecified")
        dead = self._owner_clients.pop(addr, None)
        if dead is not None:
            spawn(dead.close())

    async def _register_worker_liveness(self):
        try:
            await self.control.call("register_worker", {
                "worker_id": self.worker_id.binary(),
                "address": self.address,
                "node_id": self.node_id_hex,
                "job_id": self.job_id.binary(),
                "mode": self.mode,
            }, timeout=10)
        except Exception:  # noqa: BLE001 — records are best-effort
            logger.debug("worker liveness registration failed", exc_info=True)

    async def _borrow_reaper_loop(self):
        """Owner-side borrower-death reconciliation (reference:
        reference_counter.h borrower cleanup, driven there by pubsub worker-
        failure notices): probe each borrower address; failed probes only
        TRIGGER a lookup of the control store's authoritative worker/node
        death records — borrows are dropped solely on a recorded death,
        never on timeouts alone. A borrower that is alive but unresponsive
        (GIL-bound native call, long compile, transient partition) keeps
        its borrows indefinitely (ADVICE r5 #2). Probes are cheap (one ping
        per distinct borrower per period) and only run while borrows
        exist."""
        period = GLOBAL_CONFIG.get("borrow_reaper_period_s")
        strikes = GLOBAL_CONFIG.get("borrow_reaper_strikes")
        failures: Dict[str, int] = {}
        while not self._closed:
            await asyncio.sleep(period)
            live = self.ref_counter.borrower_addresses()
            for addr in list(failures):
                if addr not in live:
                    failures.pop(addr, None)
            for addr in live:
                if self._closed:
                    return
                try:
                    client = await self._owner_client(addr)
                    await client.call("ping", {}, timeout=5)
                    failures.pop(addr, None)
                    continue
                except Exception:  # noqa: BLE001 — maybe gone, maybe slow
                    # One missed ping is NOT death: probe a few times before
                    # even bothering the control store.
                    failures[addr] = failures.get(addr, 0) + 1
                    if failures[addr] < strikes:
                        continue
                # Unreachable for `strikes` consecutive probes: consult the
                # authoritative death records. Free ONLY on a recorded
                # worker/node/driver death — an unknown or merely silent
                # address keeps its borrows (leaking beats premature free).
                try:
                    verdict = await self.control.call(
                        "check_worker_liveness", {"address": addr},
                        timeout=10)
                except Exception:  # noqa: BLE001 — control store blip
                    continue
                if not verdict.get("dead"):
                    # alive-but-stalled (or not yet recorded): keep probing
                    # from a clean slate rather than hammering the lookup
                    failures[addr] = 0
                    continue
                failures.pop(addr, None)
                dropped = self.ref_counter.drop_borrower_process(addr)
                if dropped:
                    logger.info(
                        "reaped %d borrow(s) held by dead borrower %s "
                        "(control store confirmed death)", dropped, addr)
                # only THEN retire the pooled client (closing it earlier
                # would fail in-flight RPCs to a live peer)
                dead = self._owner_clients.pop(addr, None)
                if dead is not None:
                    spawn(dead.close())

    async def _telemetry_loop(self):
        """Flush buffered task events (with their drop accounting) to the
        control store, and ship metric DELTAS node-locally: the daemon
        pre-aggregates every worker's series into one per-node set (with a
        cardinality cap) before the control store sees them — at 1000 nodes
        the store accumulates per-node aggregates, not per-worker snapshots
        (reference: task_event_buffer.h periodic GCS flush; the per-node
        metrics agent)."""
        from ray_tpu_torch.util import metrics as metrics_mod

        period = GLOBAL_CONFIG.get("telemetry_flush_period_s")
        # Exactly-once delta shipping: a taken delta batch is FROZEN with a
        # sequence number and re-sent verbatim until acked — receivers
        # dedup by (reporter, seq), so an applied-but-unacked flush (reply
        # lost to a timeout OR a dropped connection) cannot double-count.
        # The destination is fixed for the process (the daemon when one
        # exists, else the store): falling back across destinations on a
        # connection error would escape the per-reporter dedup domain and
        # double-count exactly the batches the machinery exists to protect.
        # An idle interval still sends an EMPTY keepalive report — the
        # store's stale-reporter prune must never collect a live
        # reporter's accumulated totals.
        pending: Optional[list] = None  # [seq, series]
        seq = 0
        while not self._closed:
            await asyncio.sleep(period)
            events, dropped = self.task_events.drain()
            try:
                if events or dropped:
                    await self.control.call(
                        "report_task_events",
                        {"events": events, "dropped": dropped}, timeout=10)
                    events, dropped = [], 0
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — telemetry must never kill the worker
                # control store blip: keep the batch for the next flush
                self.task_events.requeue(events, dropped)
            if pending is None:
                snap = metrics_mod.take_delta()
                if snap:
                    seq += 1
                    pending = [seq, snap]
            payload = {"worker_id": self.worker_id.binary(),
                       "delta": True,
                       "metrics": pending[1] if pending else [],
                       **({"seq": pending[0]} if pending else {})}
            daemon = getattr(self, "daemon", None)
            try:
                if daemon is not None:
                    await daemon.call("report_metrics", payload, timeout=10)
                else:
                    await self.control.call(
                        "report_metrics", payload, timeout=10)
                pending = None
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — retry the SAME frozen batch
                # (same seq) next tick; workers fate-share with the daemon,
                # so a dead destination resolves itself shortly
                pass

    async def _daemon_fate_watch(self):
        """Exit the worker process when its daemon is gone (reference:
        raylet↔worker fate sharing via the IPC socket). Wall-clock window,
        not a probe count: under CPU starvation a loaded daemon can miss
        several short probes while being perfectly alive — the bar matches
        the cluster's own node-death declaration (health_check_timeout_s)."""
        period = GLOBAL_CONFIG.get("health_check_period_s")
        window = GLOBAL_CONFIG.get("health_check_timeout_s") * 1.5
        first_fail = None
        while not self._closed:
            await asyncio.sleep(period)
            try:
                await self.daemon.call("ping", {}, timeout=period * 4)
                first_fail = None
            except Exception:  # noqa: BLE001 — daemon unreachable
                now = time.monotonic()
                if first_fail is None:
                    first_fail = now
                elif now - first_fail >= window:
                    logger.error(
                        "node daemon unreachable for %.0fs; worker exiting "
                        "(fate-sharing)", now - first_fail)
                    os._exit(1)

    async def close(self):
        self._closed = True
        if getattr(self, "_fate_task", None) is not None:
            self._fate_task.cancel()
        if self._telemetry_task is not None:
            self._telemetry_task.cancel()
        if getattr(self, "_lease_sweep_task", None) is not None:
            self._lease_sweep_task.cancel()
        if getattr(self, "_borrow_reaper_task", None) is not None:
            self._borrow_reaper_task.cancel()
        # return every cached lease so the daemons free the capacity now
        # (snapshot: an in-flight submit can insert a pool key mid-await).
        # One shared deadline bounds the whole sweep: against live daemons
        # each return is a millisecond call, and a closing worker must not
        # burn a retry chain per lease on daemons that are already gone —
        # they reclaim leases from the recorded worker death anyway.
        from ray_tpu_torch._private.retry import deadline_from_timeout

        sweep_deadline = deadline_from_timeout(1.5)
        for pool in list(self._lease_pools.values()):
            for lease in list(pool["idle"]):
                if time.monotonic() >= sweep_deadline:
                    break
                try:
                    await self._return_lease_quiet(
                        lease["daemon_address"], lease["lease_id"],
                        deadline=sweep_deadline)
                except Exception:  # noqa: BLE001
                    pass
        self._lease_pools.clear()
        await self.server.stop()
        await self.control.close()
        await self.daemon.close()
        for c in list(self._worker_clients.values()) + list(self._owner_clients.values()):
            await c.close()
        for st in self._actor_states.values():
            if st.client:
                await st.client.close()
        if self.store is not None:
            self.store.close()

    def schedule(self, coro) -> None:
        """Schedule a coroutine from any thread; pins the task (the loop keeps
        only weak task refs — see aio.spawn)."""
        if self._closed:
            coro.close()
            return
        if self._loop_running_here():
            spawn(coro)
        else:
            fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
            self._bg_futures.add(fut)
            fut.add_done_callback(self._bg_futures.discard)

    def _loop_running_here(self) -> bool:
        tid = self._loop_thread_id
        if tid is None:
            try:
                running = asyncio.get_running_loop() is self.loop
            except RuntimeError:
                return False
            if running:
                self._loop_thread_id = threading.get_ident()
            return running
        return tid == threading.get_ident()

    def run_sync(self, coro, timeout: Optional[float] = None):
        """Bridge a coroutine to sync callers (driver public API)."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def owns(self, ref: ObjectRef) -> bool:
        return ref._owner_worker_id == self.worker_id.binary()

    def next_task_id(self) -> TaskID:
        with self._lock:
            self._task_index += 1
            return TaskID.for_task(self.job_id, self.current_task_id, self._task_index)

    # ------------------------------------------------------------------
    # function export/fetch (reference: python/ray/_private/function_manager.py)
    # ------------------------------------------------------------------

    async def export_function(self, key: str, obj: Any):
        if key in self._exported:
            return
        blob = cloudpickle.dumps(obj)
        await self.control.call(
            "kv_put",
            {"ns": "fn", "key": key.encode(), "value": blob, "overwrite": False},
        )
        self._exported.add(key)

    async def fetch_function(self, key: str) -> Any:
        if key in self._function_cache:
            return self._function_cache[key]
        deadline = time.monotonic() + 30
        while True:
            reply = await self.control.call("kv_get", {"ns": "fn", "key": key.encode()})
            if reply["value"] is not None:
                fn = cloudpickle.loads(reply["value"])
                self._function_cache[key] = fn
                return fn
            if time.monotonic() > deadline:
                raise RayTpuError(f"function {key} never appeared in the control store")
            await asyncio.sleep(0.05)

    # ------------------------------------------------------------------
    # put / get / wait
    # ------------------------------------------------------------------

    async def put_object(self, value: Any) -> ObjectRef:
        with self._lock:
            self._put_index += 1
            oid = ObjectID.for_put(self.current_task_id, self._put_index)
        sobj = ser.serialize(value)
        ref = ObjectRef(oid, self.address, self.worker_id.binary())
        if sobj.total_bytes <= self._inline_max:
            self.memory_store.put(oid.binary(), sobj.to_bytes(), META_NORMAL)
        elif self.store is None:
            # remote-client mode: ship the bytes to the adopted daemon's
            # store over RPC (chunked), then record it as the home location
            await self._remote_put(oid, sobj)
            self.memory_store.set_location(
                oid.binary(),
                {"daemon": self.daemon_address, "node_id": self.node_id_hex},
            )
        else:
            view = await self._create_with_spill(oid, sobj.total_bytes)
            sobj.write_into(view)
            view.release()
            self.store.seal(oid)
            self.memory_store.set_location(
                oid.binary(),
                {"daemon": self.daemon_address, "node_id": self.node_id_hex, "local": True},
            )
        return ref

    async def _remote_put(self, oid: ObjectID, sobj: "ser.SerializedObject"):
        """Write a large object into the adopted daemon's store over RPC
        (remote-client mode; reference: ray client server-side puts)."""
        data = sobj.to_bytes()
        reply = await self.daemon.call("create_object", {
            "object_id": oid.binary(), "size": len(data), "meta": META_NORMAL,
        }, timeout=60)
        if not reply.get("ok"):
            raise ObjectStoreFullError(reply.get("error", "create_object failed"))
        if reply.get("exists"):
            return
        chunk = GLOBAL_CONFIG.get("object_chunk_bytes")
        sem = asyncio.Semaphore(8)

        async def write(off: int):
            async with sem:
                r = await self.daemon.call("write_chunk", {
                    "object_id": oid.binary(), "offset": off,
                    "data": data[off:off + chunk],
                }, timeout=60)
                if not r.get("ok"):
                    raise RayTpuError(
                        f"remote put failed mid-transfer: {r.get('error')}"
                    )

        await asyncio.gather(*[write(o) for o in range(0, len(data), chunk)])
        r = await self.daemon.call("seal_object", {"object_id": oid.binary()},
                                   timeout=30)
        if not r.get("ok"):
            # e.g. the daemon swept this create as stale mid-stall: the
            # object does not exist; failing the put here beats handing out
            # a ref that can never resolve
            raise RayTpuError(f"remote put failed to seal: {r.get('error')}")

    async def get_objects(self, refs: Sequence[ObjectRef],
                          timeout: Optional[float] = None) -> List[Any]:
        return list(
            await asyncio.gather(*[self._get_one(r, timeout) for r in refs])
        )

    async def get_async(self, ref: ObjectRef, timeout: Optional[float] = None) -> Any:
        return await self._get_one(ref, timeout)

    async def _get_one(self, ref: ObjectRef, timeout: Optional[float] = None) -> Any:
        oid = ref.binary()
        deadline = None if timeout is None else time.monotonic() + timeout
        if self.owns(ref):
            while True:
                fut = self.memory_store.wait_future(oid)
                await self._await_deadline(fut, deadline, ref)
                if oid in self.memory_store.objects:
                    data, meta = self.memory_store.objects[oid]
                    return self._materialize(data, meta, copy_buffers=False)
                location = self.memory_store.locations.get(oid)
                if location is None:
                    # a concurrent reconstruction cleared the stale location;
                    # loop back and wait for the fresh execution to land
                    await asyncio.sleep(0)
                    continue
                try:
                    self.recovery.note_fetching(oid)
                    value = await self._read_store_object(ref, location, deadline)
                    self.recovery.note_local(oid)
                    return value
                except ObjectLostError:
                    # the store node died with the object; recompute from
                    # lineage and retry with the fresh location (bounded by
                    # the caller's deadline — recovery continues regardless)
                    if not await self._bounded(
                        self.recovery.recover(oid, location.get("node_id")),
                        deadline, ref, "reconstructing",
                    ):
                        raise
        # borrowed: ask the owner (bounded by the caller's deadline)
        return await self._fetch_via_owner(ref, deadline, copy_buffers=False)

    async def _bounded(self, coro, deadline, ref: ObjectRef, what: str):
        """Await `coro`, raising GetTimeoutError past `deadline`. The work
        itself is shielded: a caller timeout never aborts owner-side
        recovery or an in-flight owner RPC."""
        if deadline is None:
            return await coro
        try:
            return await asyncio.wait_for(
                asyncio.shield(spawn(coro)),
                max(0.0, deadline - time.monotonic()),
            )
        except asyncio.TimeoutError:
            raise GetTimeoutError(f"get() timed out {what} {ref.hex()}") from None

    async def _fetch_via_owner(self, ref: ObjectRef, deadline,
                               copy_buffers: bool) -> Any:
        """Borrower-side fetch: ask the owner for the value or its location,
        read the store copy, and on a lost store node ask the owner to
        reconstruct from lineage — all bounded by the caller's deadline
        (owner-side recovery keeps going past a caller timeout)."""
        oid = ref.binary()
        reconstruct_tries = 0
        while True:
            reply = await self._bounded(
                self._call_owner(ref, "get_object", {"object_id": oid}),
                deadline, ref, "waiting for",
            )
            if reply.get("error"):
                raise ObjectLostError(ref.hex(), reply["error"])
            if "data" in reply and reply["data"] is not None:
                return self._materialize(reply["data"], reply["meta"],
                                         copy_buffers=copy_buffers)
            location = reply["location"]
            try:
                return await self._read_store_object(ref, location, deadline)
            except ObjectLostError:
                # ask the owner to rebuild it from lineage, then re-fetch
                reconstruct_tries += 1
                if reconstruct_tries > GLOBAL_CONFIG.get("max_lineage_reconstructions"):
                    raise
                rec = await self._bounded(
                    self._call_owner(ref, "reconstruct_object", {
                        "object_id": oid,
                        "failed_node": location.get("node_id"),
                    }),
                    deadline, ref, "reconstructing",
                )
                if not rec.get("ok"):
                    raise

    async def _await_deadline(self, fut, deadline, ref):
        if deadline is None or fut.done():
            await fut
            return
        # leaner than asyncio.wait_for: one timer handle, no nested timeout
        # context — this sits on the per-ref get() hot path. The future is
        # per-caller (memory_store.wait_future hands out fresh ones), so
        # cancelling it on timeout affects no other getter.
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            fut.cancel()
            raise GetTimeoutError(
                f"get() timed out waiting for {ref.hex()}")
        timer = self.loop.call_later(remaining, fut.cancel)
        try:
            await fut
        except asyncio.CancelledError:
            if fut.cancelled() and time.monotonic() >= deadline - 0.001:
                raise GetTimeoutError(
                    f"get() timed out waiting for {ref.hex()}") from None
            raise
        finally:
            timer.cancel()

    async def _read_store_object(self, ref: ObjectRef, location: dict, deadline) -> Any:
        if self.store is None:
            return await self._remote_read(ref, location, deadline)
        oid = ref.object_id()
        is_local = location.get("node_id") == self.node_id_hex
        # authoritative death notice poisoned this location (see
        # recovery.on_node_death): a still-valid LOCAL copy may exist in
        # this node's store, but a remote pull from the dead daemon would
        # only burn the deadline — fail over to recovery immediately
        if location.get("dead") and not is_local and not self.store.contains(oid):
            why = location.get("death_reason") or "authoritative death record"
            raise ObjectLostError(
                ref.hex(),
                f"store node {location.get('node_id', '')[:8]} is dead "
                f"({why})")
        pulled = False
        # Pin-or-recover loop: between any check and the pinning get() the
        # spill loop may write the object to disk and delete it from shm, so
        # a one-shot contains()/restore decision can hang forever. Each miss
        # retries the applicable recovery (remote pull / spill restore) until
        # the pin lands or the deadline passes.
        last_restore = 0.0
        failed_restores = 0
        while True:
            res = self.store.get(oid)  # pins on success
            if res is not None:
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise GetTimeoutError(f"get() timed out materializing {ref.hex()}")
            if not is_local and not pulled:
                reply = await self.daemon.call(
                    "pull_object",
                    {"object_id": oid.binary(), "from_address": location["daemon"]},
                    timeout=None if deadline is None else max(0.1, deadline - time.monotonic()),
                )
                if not reply.get("ok"):
                    raise ObjectLostError(ref.hex(), reply.get("error", "pull failed"))
                pulled = True
                continue
            # local (or already pulled): possibly spilled to disk. Throttle
            # the restore RPC — the common miss is a producer mid-seal, which
            # the cheap local shm poll below picks up without daemon traffic.
            now = time.monotonic()
            if now - last_restore > 0.2:
                last_restore = now
                reply = await self.daemon.call(
                    "restore_object", {"object_id": oid.binary()}, timeout=30
                )
                if reply.get("ok"):
                    continue
                failed_restores += 1
                # not in shm, not spilled, and given ~5s of mid-seal grace:
                # the object is gone (evicted or never landed) — surface it
                # so the owner's lineage reconstruction can recompute it
                if failed_restores >= 25:
                    raise ObjectLostError(
                        ref.hex(), "object missing from local store and spill dir"
                    )
            await asyncio.sleep(0.002)
        view, meta = res
        if meta == META_ERROR:
            try:
                raise self._deserialize_error(bytes(view))
            finally:
                self.store.release(oid)
        # Zero-copy: buffers alias shm; the store pin is released when the
        # last array aliasing the segment is GC'd (ser._Pin finalizer).
        return ser.deserialize(
            view, copy_buffers=False,
            release=functools.partial(self.store.release, oid),
        )

    async def _remote_read(self, ref: ObjectRef, location: dict, deadline) -> Any:
        """Remote-client mode: materialize a store-resident object by asking
        the adopted daemon to pull it locally, then fetching its bytes in
        chunks over RPC (no shm mapping on this side)."""
        oid = ref.object_id()

        def remaining(default: float) -> float:
            if deadline is None:
                return default
            left = deadline - time.monotonic()
            if left <= 0:
                raise GetTimeoutError(
                    f"get() timed out materializing {ref.hex()} remotely"
                )
            return min(default, max(0.1, left))

        reply = await self.daemon.call(
            "pull_object",
            {"object_id": oid.binary(), "from_address": location["daemon"]},
            timeout=None if deadline is None else remaining(1e9),
        )
        if not reply.get("ok"):
            raise ObjectLostError(ref.hex(), reply.get("error", "pull failed"))
        info = await self.daemon.call(
            "fetch_object_info", {"object_id": oid.binary()},
            timeout=remaining(30),
        )
        if not info.get("found"):
            raise ObjectLostError(ref.hex(), "object vanished after pull")
        size, meta = info["size"], info["metadata"]
        buf = bytearray(size)
        from ray_tpu_torch.runtime.transfer import fetch_chunks

        await fetch_chunks(
            self.daemon.call, oid.binary(), size, buf,
            chunk_bytes=GLOBAL_CONFIG.get("object_chunk_bytes"),
            timeout_for=remaining,
            missing_error=lambda: ObjectLostError(
                ref.hex(), "object vanished mid-read"),
        )
        if meta == META_ERROR:
            raise self._deserialize_error(bytes(buf))
        return ser.deserialize(bytes(buf), copy_buffers=True)

    def _materialize(self, data: bytes, meta: int, copy_buffers: bool) -> Any:
        if meta == META_ERROR:
            raise self._deserialize_error(data)
        return ser.deserialize(data, copy_buffers=copy_buffers)

    def _deserialize_error(self, data) -> Exception:
        try:
            exc = ser.deserialize(data, copy_buffers=True)
            if isinstance(exc, BaseException):
                return exc
            return RayTpuError(str(exc))
        except Exception:  # noqa: BLE001
            return RayTpuError("task failed and its error could not be deserialized")

    async def wait_objects(self, refs: Sequence[ObjectRef], num_returns: int,
                           timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        pending = {r: None for r in refs}
        ready: List[ObjectRef] = []
        deadline = None if timeout is None else time.monotonic() + timeout

        async def ready_one(r: ObjectRef):
            if self.owns(r):
                await self.memory_store.wait_future(r.binary())
            else:
                await self._call_owner(r, "wait_object", {"object_id": r.binary()})
            return r

        tasks = {spawn(ready_one(r)): r for r in pending}
        try:
            while tasks and len(ready) < num_returns:
                budget = None if deadline is None else max(0.0, deadline - time.monotonic())
                done, _ = await asyncio.wait(
                    tasks, timeout=budget, return_when=asyncio.FIRST_COMPLETED
                )
                if not done:
                    break
                for d in done:
                    r = tasks.pop(d)
                    # retrieve the exception unconditionally (else asyncio
                    # logs "Task exception was never retrieved" for errored
                    # waiters completing past the cap), then cap at
                    # num_returns — ray.wait returns at most num_returns
                    # ready refs; the rest stay in the not-ready list
                    ok = not d.cancelled() and d.exception() is None
                    if ok and len(ready) < num_returns:
                        ready.append(r)
        finally:
            for t in tasks:
                t.cancel()
        not_ready = [r for r in refs if r not in ready]
        return ready, not_ready

    # ------------------------------------------------------------------
    # owner-side object service (serving borrowers and executors)
    # ------------------------------------------------------------------

    async def rpc_get_object(self, conn_id: int, payload: dict) -> dict:
        oid = payload["object_id"]
        await self.memory_store.wait_future(oid)
        if oid in self.memory_store.objects:
            data, meta = self.memory_store.objects[oid]
            return {"data": data, "meta": meta}
        loc = self.memory_store.locations.get(oid)
        if loc is None:
            return {"error": "object not found at owner"}
        return {"data": None, "location": loc}

    async def rpc_get_objects_batch(self, conn_id: int, payload: dict) -> dict:
        """Batched get_object: one RPC for a many-arg task's refs instead
        of one round trip per ref (reference: the 10k-args-per-task
        envelope, release/benchmarks/README.md:27 — per-message overhead
        dominates tiny-arg resolution without this)."""
        oids = payload["object_ids"]
        await asyncio.gather(*[self.memory_store.wait_future(o)
                               for o in oids])
        out = []
        for oid in oids:
            if oid in self.memory_store.objects:
                data, meta = self.memory_store.objects[oid]
                out.append({"data": data, "meta": meta})
                continue
            loc = self.memory_store.locations.get(oid)
            out.append({"error": "object not found at owner"}
                       if loc is None else {"data": None, "location": loc})
        return {"objects": out}

    async def resolve_args_batch(self, wire_args: list) -> list:
        """Executor-side arg resolution with owner-fetch batching: refs
        owned elsewhere and absent from the local store group into
        get_objects_batch calls per owner; inline/local/owned args keep the
        resolve_arg fast paths."""
        results: list = [None] * len(wire_args)
        local_idx: list = []
        by_owner: Dict[str, list] = {}
        for i, a in enumerate(wire_args):
            if "inline" in a:
                results[i] = ser.deserialize(a["inline"], copy_buffers=True)
                continue
            ref = ObjectRef(ObjectID(a["ref"]), a["owner"],
                            a["owner_worker_id"], _register=False)
            if self.owns(ref) or (
                    self.store is not None
                    and self.store.contains(ref.object_id())):
                local_idx.append(i)
            else:
                by_owner.setdefault(a["owner"], []).append((i, a))

        async def fetch_group(owner: str, items: list):
            chunk = 2048
            for c0 in range(0, len(items), chunk):
                part = items[c0:c0 + chunk]
                ref0 = ObjectRef(ObjectID(part[0][1]["ref"]), owner,
                                 part[0][1]["owner_worker_id"],
                                 _register=False)
                try:
                    client = await self._owner_client(owner)
                    reply = await client.call("get_objects_batch", {
                        "object_ids": [a["ref"] for _i, a in part],
                    }, timeout=None)
                except RpcError as e:
                    raise ObjectLostError(
                        ref0.hex(),
                        f"owner at {owner} unreachable: {e}") from e
                store_resident = []
                for (i, a), rep in zip(part, reply["objects"]):
                    if rep.get("error"):
                        raise ObjectLostError(
                            ObjectID(a["ref"]).hex(), rep["error"])
                    if rep.get("data") is not None:
                        results[i] = self._materialize(
                            rep["data"], rep["meta"], copy_buffers=True)
                    else:
                        # store-resident value: the single-ref path handles
                        # location reads + lineage reconstruction
                        store_resident.append((i, a))
                if store_resident:
                    vals = await asyncio.gather(
                        *[self.resolve_arg(a) for _i, a in store_resident])
                    for (i, _a), v in zip(store_resident, vals):
                        results[i] = v

        local_vals = await asyncio.gather(
            *[self.resolve_arg(wire_args[i]) for i in local_idx])
        for i, v in zip(local_idx, local_vals):
            results[i] = v
        await asyncio.gather(
            *[fetch_group(owner, items)
              for owner, items in by_owner.items()])
        return results

    async def rpc_wait_object(self, conn_id: int, payload: dict) -> dict:
        await self.memory_store.wait_future(payload["object_id"])
        return {"ok": True}

    async def rpc_add_borrow(self, conn_id: int, payload: dict) -> dict:
        self.ref_counter.add_borrower(payload["object_id"],
                                      payload.get("borrower", ""))
        return {"ok": True}

    async def rpc_remove_borrow(self, conn_id: int, payload: dict) -> dict:
        self.ref_counter.remove_borrower(payload["object_id"],
                                         payload.get("borrower", ""))
        return {"ok": True}

    # ------------------------------------------------------------------
    # streaming generators — owner side (reference: task_manager.h:88
    # ObjectRefStream + core_worker.proto ReportGeneratorItemReturns)
    # ------------------------------------------------------------------

    def _record_return_entry(self, ret: dict):
        oid = ret["object_id"]
        if ret.get("inline") is not None:
            self.memory_store.put(oid, ret["inline"], ret.get("meta", META_NORMAL))
        else:
            new = ret["location"]
            old = self.memory_store.locations.get(oid)
            if old is not None and old.get("daemon") != new.get("daemon"):
                # a retry/reconstruction relocated the object; free the
                # superseded copy so healthy nodes don't accumulate orphans
                spawn(self._free_store_copy(oid, old))
            self.memory_store.set_location(oid, new)

    async def _free_store_copy(self, oid: bytes, loc: dict):
        try:
            if loc.get("node_id") == self.node_id_hex and self.store is not None:
                self.store.delete(ObjectID(oid))
            else:
                client = await self._owner_client(loc["daemon"])
                await client.call("free_objects", {"object_ids": [oid]}, timeout=5)
        except Exception:  # noqa: BLE001 — the holder may be the dead node
            pass

    def _stream_end(self, tid: bytes, total: int):
        st = self._streams.get(tid)
        if st is None or st.end is not None:
            return
        st.produced = max(st.produced, total)
        st.end = st.produced
        st.wake_all()
        st.wake_consumers()

    async def rpc_report_stream_item(self, conn_id: int, payload: dict) -> dict:
        tid = payload["task_id"]
        st = self._streams.get(tid)
        if st is None or st.cancelled:
            return {"cancelled": True, "consumed": 0}
        self._record_return_entry(payload["ret"])
        st.produced = max(st.produced, payload["index"] + 1)
        st.wake_all()
        return {"cancelled": False, "consumed": st.consumed}

    async def rpc_stream_wait_consumed(self, conn_id: int, payload: dict) -> dict:
        """Executor-side backpressure: block until the consumer has taken
        `until` items (or the stream is cancelled/dropped)."""
        tid = payload["task_id"]
        st = self._streams.get(tid)
        if st is None or st.cancelled or st.consumed >= payload["until"]:
            return {"cancelled": st is None or st.cancelled, "consumed": 0 if st is None else st.consumed}
        fut = self.loop.create_future()
        st.consume_waiters.append((payload["until"], fut))
        await fut
        st2 = self._streams.get(tid)
        return {
            "cancelled": st2 is None or st2.cancelled,
            "consumed": 0 if st2 is None else st2.consumed,
        }

    async def stream_next(self, tid: bytes) -> Optional["ObjectRef"]:
        """Next item ref, or None when the stream is exhausted. The end is
        signalled by a sentinel (not an exception) because raising through
        run_coroutine_threadsafe chains tracebacks into a Task↔exception
        reference cycle that pins caller frames until a full GC."""
        st = self._streams.get(tid)
        if st is None:
            return None
        while True:
            if st.next_read < st.produced:
                idx = st.next_read
                st.next_read += 1
                st.consumed += 1
                st.wake_consumers()
                oid = ObjectID.for_task_return(TaskID(tid), idx)
                return ObjectRef(oid, self.address, self.worker_id.binary())
            if st.cancelled or (st.end is not None and st.next_read >= st.end):
                return None
            fut = self.loop.create_future()
            st.waiters.append(fut)
            await fut

    async def stream_drop(self, tid: bytes):
        """Generator GC'd: cancel the producer, release backpressure waiters,
        and free unconsumed item objects."""
        st = self._streams.pop(tid, None)
        if st is None:
            return
        st.cancelled = True
        st.wake_all()
        st.wake_consumers()
        try:
            await self.cancel_task_by_id(tid, force=False)
        except Exception:  # noqa: BLE001 — producer may have finished already
            pass
        for idx in range(st.next_read, st.produced):
            oid = ObjectID.for_task_return(TaskID(tid), idx)
            await self.free_owned_object(oid)

    # ------------------------------------------------------------------
    # task cancellation (reference: core_worker.proto CancelTask,
    # normal_task_submitter.cc CancelTask)
    # ------------------------------------------------------------------

    async def cancel_task(self, ref: "ObjectRef", force: bool = False,
                          recursive: bool = False) -> bool:
        tid = self._return_to_task.get(ref.binary())
        if tid is None:
            return False
        return await self.cancel_task_by_id(tid, force=force)

    async def cancel_task_by_id(self, tid: bytes, force: bool = False) -> bool:
        sub = self._submissions.get(tid)
        if sub is None:
            return False
        sub["cancelled"] = True
        spec: TaskSpec = sub["spec"]
        if spec.is_streaming:
            # Mark the owner-side stream cancelled and release both waiter
            # groups: a producer parked in stream_wait_consumed (or its next
            # report_stream_item) sees cancelled and aborts; the consumer
            # drains already-produced items and then stops.
            st = self._streams.get(tid)
            if st is not None:
                st.cancelled = True
                st.wake_all()
                st.wake_consumers(force=True)
        if sub["state"] == "running" and sub["worker"]:
            reply = {}
            try:
                client = await self._worker_client(sub["worker"])
                reply = await client.call(
                    "cancel_task", {"task_id": tid, "force": force}, timeout=10
                )
            except Exception:  # noqa: BLE001 — worker already gone
                pass
            if not force and reply.get("ok") and reply.get("running"):
                # The executor raises TaskCancelledError into the task's
                # thread, but async-exc delivery waits for a Python bytecode
                # boundary — a task blocked in C (time.sleep, IO) would pin
                # the caller's get() arbitrarily long. Resolve the returns
                # now; the eventual stale reply is dropped (reference:
                # CancelTask acks fail the task at the owner promptly).
                self._fail_task(spec, TaskCancelledError(
                    f"task {spec.name or spec.function_key} was cancelled"))
            # otherwise the push_task reply (an error for a cancelled task)
            # resolves the returns; force-kill resolves via the retry loop
            # seeing the cancelled flag
        elif spec.kind == pb.TASK_KIND_ACTOR_TASK:
            # queued actor task: do NOT hard-cancel the submit coroutine — it
            # must still deliver a tombstone for its sequence slot (see
            # _submit_actor_with_retries)
            pass
        elif sub["atask"] is not None:
            sub["atask"].cancel()
        else:
            # fast-lane queued entry: no coroutine exists; resolve the
            # returns now and let the feeder skip (and untrack) the entry
            self._fail_task(spec, TaskCancelledError(
                f"task {spec.name or spec.function_key} was cancelled"))
        return True

    # executor side: delegate to the task executor
    async def rpc_cancel_task(self, conn_id: int, payload: dict) -> dict:
        if self.executor is None:
            return {"ok": False}
        return self.executor.cancel(payload["task_id"], payload.get("force", False))

    async def notify_owner(self, owner_address: str, method: str, oid: bytes):
        if owner_address == self.address:
            return
        try:
            client = await self._owner_client(owner_address)
            await client.call(method, {
                "object_id": oid,
                # borrow bookkeeping is keyed by borrower identity so the
                # owner can reconcile borrows of DEAD borrowers (reference:
                # reference_counter.h borrower death cleanup)
                "borrower": self.address,
            }, timeout=10)
        except Exception:  # noqa: BLE001 — owner may be gone; borrow bookkeeping is moot
            pass

    async def _owner_client(self, address: str) -> RpcClient:
        client = self._owner_clients.get(address)
        if client is None:
            client = RpcClient(address, name="owner-client")
            await client.connect()
            self._owner_clients[address] = client
        return client

    async def _call_owner(self, ref: ObjectRef, method: str, payload: dict) -> dict:
        try:
            client = await self._owner_client(ref.owner_address)
            return await client.call(method, payload, timeout=None)
        except RpcError as e:
            raise ObjectLostError(
                ref.hex(), f"owner at {ref.owner_address} unreachable: {e}"
            ) from e

    async def free_owned_object(self, oid: ObjectID):
        key = oid.binary()
        loc = self.memory_store.locations.get(key)
        self.memory_store.delete(key)
        self.recovery.drop_lineage_for(key)
        if loc is not None:
            await self._free_store_copy(key, loc)

    # ------------------------------------------------------------------
    # task submission (reference: normal_task_submitter.h:87)
    # ------------------------------------------------------------------

    async def serialize_args(self, args: tuple, kwargs: dict) -> List[dict]:
        """Serialize positional + keyword args. Each wire entry is either a
        pass-by-reference {"ref", "owner", ...} or an {"inline"} value, with an
        optional "kw" name; refs (positional OR keyword) are resolved to their
        values on the executor, like the reference's plasma-arg resolution."""
        out = []
        for kw_name, value in [
            *((None, v) for v in args),
            *kwargs.items(),
        ]:
            if isinstance(value, ObjectRef):
                entry = {
                    "ref": value.binary(),
                    "owner": value.owner_address,
                    "owner_worker_id": value._owner_worker_id,
                    # pin the caller's ref until the task completes: if the
                    # caller drops it right after .remote(), the owner would
                    # free the object while the executor is still resolving
                    # it (reference: task args are pinned by the submitter)
                    "_pyref": value,  # stripped before wire
                }
            else:
                sobj = ser.serialize(value)
                if sobj.total_bytes > self._inline_max or sobj.contained_refs:
                    ref = await self.put_object(value)
                    entry = {
                        "ref": ref.binary(),
                        "owner": ref.owner_address,
                        "owner_worker_id": ref._owner_worker_id,
                        # keep the put alive until the task completes
                        "_pyref": ref,  # stripped before wire
                    }
                else:
                    entry = {"inline": sobj.to_bytes()}
            if kw_name is not None:
                entry["kw"] = kw_name
            out.append(entry)
        return out

    def serialize_args_sync(self, args: tuple, kwargs: dict):
        """Caller-thread arg serialization for the non-blocking submission
        path: serialization errors raise HERE, at the .remote() call site
        (matching the reference, where submit_task serializes synchronously
        in the Cython seam before the async C++ pipeline takes over).

        Returns (wire_args, pyrefs, pending_puts); pending_puts are
        (ObjectID, SerializedObject) pairs whose store writes the loop-side
        coroutine must complete before submitting — the ObjectRef/oid are
        allocated here so the wire entry is final."""
        out, pyrefs, pending = [], [], []
        for kw_name, value in [
            *((None, v) for v in args),
            *kwargs.items(),
        ]:
            if isinstance(value, ObjectRef):
                entry = {
                    "ref": value.binary(),
                    "owner": value.owner_address,
                    "owner_worker_id": value._owner_worker_id,
                }
                pyrefs.append(value)
            else:
                sobj = ser.serialize(value)
                if sobj.total_bytes > self._inline_max or sobj.contained_refs:
                    with self._lock:
                        self._put_index += 1
                        oid = ObjectID.for_put(
                            self.current_task_id, self._put_index)
                    ref = ObjectRef(oid, self.address, self.worker_id.binary())
                    pending.append((oid, sobj))
                    entry = {
                        "ref": ref.binary(),
                        "owner": ref.owner_address,
                        "owner_worker_id": ref._owner_worker_id,
                    }
                    pyrefs.append(ref)
                else:
                    entry = {"inline": sobj.to_bytes()}
            if kw_name is not None:
                entry["kw"] = kw_name
            out.append(entry)
        return out, pyrefs, pending

    async def _complete_put(self, oid: ObjectID, sobj: "ser.SerializedObject"):
        """Finish a caller-thread-allocated put (the write half of
        put_object): resolve the memory-store future / write shm so
        dependents and gets unblock."""
        if sobj.total_bytes <= self._inline_max:
            self.memory_store.put(oid.binary(), sobj.to_bytes(), META_NORMAL)
        elif self.store is None:
            await self._remote_put(oid, sobj)
            self.memory_store.set_location(
                oid.binary(),
                {"daemon": self.daemon_address, "node_id": self.node_id_hex},
            )
        else:
            view = await self._create_with_spill(oid, sobj.total_bytes)
            sobj.write_into(view)
            view.release()
            self.store.seal(oid)
            self.memory_store.set_location(
                oid.binary(),
                {"daemon": self.daemon_address, "node_id": self.node_id_hex,
                 "local": True},
            )

    def submit_task_fast(
        self,
        function_obj,
        function_key: str,
        args: tuple,
        kwargs: dict,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        strategy: Optional[SchedulingStrategy] = None,
        max_retries: Optional[int] = None,
        name: str = "",
        runtime_env: Optional[dict] = None,
        stream_backpressure: int = -1,
        lease_key: Any = False,
    ):
        """Non-blocking submission callable from ANY thread — the driver's
        .remote() must never wait on a loop round trip (reference:
        normal_task_submitter.h — submission is pipelined; ray_perf's async
        suite measures exactly this). Serialization runs on the caller
        thread (errors raise at the call site); everything needing the loop
        (pending put writes, export, lease/push) continues asynchronously.

        `resources`/`strategy` may be prebuilt (shared, never-mutated)
        objects and `lease_key` their precomputed scheduling key — the
        RemoteFunction caches all three across calls."""
        task_id = self.next_task_id()
        wire_args, pyrefs, pending = self.serialize_args_sync(args, kwargs)
        spec = TaskSpec(
            trace_ctx=_trace_inject(),
            task_id=task_id,
            job_id=self.job_id,
            kind=pb.TASK_KIND_NORMAL,
            function_key=function_key,
            args=wire_args,
            num_returns=num_returns,
            resources=(
                resources if isinstance(resources, ResourceSet)
                else ResourceSet(resources or {"CPU": 1.0})
            ),
            strategy=strategy or SchedulingStrategy(),
            max_retries=(
                max_retries if max_retries is not None
                else GLOBAL_CONFIG.get("max_task_retries_default")
            ),
            owner_worker_id=self.worker_id.binary(),
            owner_address=self.address,
            name=name,
            runtime_env=runtime_env or {},
            stream_backpressure=stream_backpressure,
        )
        refs = [
            ObjectRef(oid, self.address, self.worker_id.binary())
            for oid in spec.return_ids()
        ]
        if spec.trace_ctx is not None:
            # per-hop decomposition stamps ride the spec OBJECT (owner-side
            # only — nothing extra crosses the wire on the submit side)
            spec._hop = {"sub_ns": time.monotonic_ns(), "wall0": time.time()}
        if spec.is_streaming:
            self._streams[task_id.binary()] = StreamState(task_id.binary())

        # FAST LANE: inline-only args, exported function, no env prep —
        # nothing to await before delivery, so skip the per-task coroutine
        # chain entirely; the push feeder handles replies AND retries from
        # the submission entry (reference: the C++ submitter is exactly this
        # shape — no per-task task, just queues and callbacks).
        fast = (
            not spec.is_streaming
            and not pending
            and not spec.runtime_env
            and function_key in self._exported
            and not any("ref" in a for a in wire_args)
        )
        if fast:
            key = lease_key if lease_key is not False else self._lease_key(spec)
            fast = key is not None
        if fast:
            # native engine first: encode the spec to wire bytes in C++ and
            # enqueue on the lock-free ring; falls through to the Python
            # queue when the shape has no template or the ring is full. On
            # the loop thread the encode runs inline; from a driver thread
            # it rides the batched cross-thread drain — a deep burst's
            # caller-side cost must stay at spec+refs+append (the encode is
            # cheap but the submission entry bookkeeping is not).
            # trace_ctx: the ROOT sentinel (DERIVE_CTX, identity-compared) is
            # per-task-invariant and bakes into the template — tracing ON
            # keeps the native engine engaged. Explicit per-task contexts
            # (nested submissions, serve requests) ride the Python queue.
            if self._fastpath is not None and (
                    spec.trace_ctx is None
                    or spec.trace_ctx is _tracing_DERIVE_CTX()):
                if self._loop_running_here():
                    if self._fp_submit(key, spec, pyrefs):
                        return refs
                else:
                    self._xthread_submits.append(("fp", key, (spec, pyrefs)))
                    if not self._xthread_scheduled:
                        self._xthread_scheduled = True
                        self.loop.call_soon_threadsafe(
                            self._drain_xthread_submits)
                    return refs
            item = (spec, None, pyrefs)
            if self._loop_running_here():
                self._enqueue_fast(key, item)
            else:
                self._xthread_submits.append(("fast", key, item))
                if not self._xthread_scheduled:
                    self._xthread_scheduled = True
                    self.loop.call_soon_threadsafe(self._drain_xthread_submits)
            return refs

        async def finish():
            from ray_tpu_torch._private.runtime_env_mgr import prepare_runtime_env

            for oid, sobj in pending:
                await self._complete_put(oid, sobj)
            if spec.runtime_env:
                spec.runtime_env = await prepare_runtime_env(
                    spec.runtime_env, self) or {}
            await self.export_function(function_key, function_obj)
            await self._submit_with_retries(spec, pyrefs)

        if self._loop_running_here():
            atask = spawn(self._guard_submit(spec, finish()))
            self._track_submission(spec, atask)
        else:
            # batched handoff, FIFO with subsequent cancel/get calls through
            # the loop (their run_coroutine_threadsafe callbacks queue after
            # the drain callback already scheduled for this burst)
            self._xthread_submits.append(("coro", spec, finish()))
            if not self._xthread_scheduled:
                self._xthread_scheduled = True
                self.loop.call_soon_threadsafe(self._drain_xthread_submits)
        if spec.is_streaming:
            return ObjectRefGenerator(self, task_id.binary())
        return refs

    @staticmethod
    def _hop_enqueue_stamp(spec: TaskSpec):
        """Stamp the spec's queue-entry time. submit_encode is observed
        ONCE (first enqueue only): a RETRY re-entering the queue would
        otherwise fold the whole failed attempt — lease wait, RPC, backoff
        — into a microsecond-scale hop and corrupt the dominant-hop
        answer. The enqueue stamp itself always refreshes so ring_wait
        measures the CURRENT attempt's queue residency."""
        hop = getattr(spec, "_hop", None)
        if hop is None:
            return
        now = time.monotonic_ns()
        if "enq_ns" not in hop:
            hops.observe_ns("submit_encode", now - hop["sub_ns"])
        hop["enq_ns"] = now

    def _enqueue_fast(self, key: tuple, item: tuple):
        spec = item[0]
        if self._closed:
            self._fail_task(spec, RayTpuError("core worker closed"))
            return
        self._hop_enqueue_stamp(spec)
        tid = spec.task_id.binary()
        entry = {
            "state": "pending", "worker": "", "cancelled": False,
            "atask": None, "spec": spec, "attempts": 0,
            "keepalive": item[2],
        }
        self._submissions[tid] = entry
        for oid in spec.return_ids():
            self._return_to_task[oid.binary()] = tid
        q = self._push_queues.get(key)
        if q is None:
            q = self._push_queues[key] = collections.deque()
        q.append((spec, None))
        self._ensure_push_feeders(key, spec)

    def _drain_xthread_submits(self):
        # reset BEFORE popping: a producer that observes the flag still True
        # is guaranteed its append happens while this loop is still draining
        self._xthread_scheduled = False
        budget = 4096
        while self._xthread_submits:
            if budget <= 0:
                # a 100k-task burst must not monopolize the loop in one
                # callback: re-schedule the remainder so feeders and reply
                # handling interleave (the flag stays True across the gap —
                # producers piggyback instead of double-scheduling)
                self._xthread_scheduled = True
                self.loop.call_soon(self._drain_xthread_submits)
                return
            budget -= 1
            kind, a, b = self._xthread_submits.popleft()
            if kind == "fast":
                self._enqueue_fast(a, b)
            elif kind == "fp":
                spec, pyrefs = b
                if not self._fp_submit(a, spec, pyrefs):
                    # ring full / template miss: the Python queue takes it
                    self._enqueue_fast(a, (spec, None, pyrefs))
            else:
                self._spawn_tracked_submit(a, b)

    # ------------------------------------------------------------------
    # native fast path (reference: _raylet.pyx:3817 submit_task — the
    # compiled seam every .remote() crosses in the reference)
    # ------------------------------------------------------------------

    def _fp_ring_for(self, key: tuple) -> int:
        ring = self._fp_rings.get(key)
        if ring is None:
            with self._lock:
                ring = self._fp_rings.get(key)
                if ring is None:
                    # -1 latches "this key submits via Python" (ring table
                    # full — 256 distinct scheduling shapes is a lot)
                    ring = self._fastpath.ring_create()
                    self._fp_rings[key] = ring
        return ring

    def _fp_template_for(self, spec: TaskSpec, key: tuple) -> int:
        # trace marker in the key: a template encodes trace_ctx as a
        # constant fragment (None vs the DERIVE sentinel), so the same
        # shape templated with tracing off must not serve traced specs
        tkey = (spec.function_key, spec.num_returns, spec.max_retries,
                spec.name, spec.stream_backpressure,
                spec.trace_ctx is not None, key)
        tmpl = self._fp_templates.get(tkey)
        if tmpl is None:
            with self._lock:
                tmpl = self._fp_templates.get(tkey)
                if tmpl is None:
                    tmpl = _fp.build_template(self._fastpath, spec)
                    self._fp_templates[tkey] = tmpl
        return tmpl

    def _fp_pending(self, key: tuple) -> int:
        eng = self._fastpath
        if eng is None:
            return 0
        ring = self._fp_rings.get(key)
        if ring is None or ring < 0:
            return 0
        return eng.ring_len(ring)

    def _fp_submit(self, key: tuple, spec: TaskSpec, pyrefs: list) -> bool:
        """Encode + enqueue one fast-lane spec on the native ring. Runs on
        the LOOP thread (inline for loop-side submitters, via the batched
        xthread drain for driver threads — the caller thread's burst cost
        must stay at spec+refs+append). Returns False when the caller
        should fall back to the Python queue (no template for this shape,
        ring full, closed)."""
        if self._closed:
            return False
        eng = self._fastpath
        ring = self._fp_ring_for(key)
        if ring < 0:
            return False
        tmpl = self._fp_template_for(spec, key)
        if tmpl < 0:
            return False
        try:
            args_blob = _fp_pack_args(spec.args)
        except Exception:  # noqa: BLE001 — exotic arg entry: Python path
            return False
        tid = spec.task_id.binary()
        entry = {
            "state": "pending", "worker": "", "cancelled": False,
            "atask": None, "spec": spec, "attempts": 0,
            "keepalive": pyrefs, "fp": True,
        }
        self._submissions[tid] = entry
        for oid in spec.return_ids():
            self._return_to_task[oid.binary()] = tid
        if eng.encode(ring, tmpl, tid, args_blob) != 0:
            # ring full (or torn down): undo the tracking, use the deque
            self._submissions.pop(tid, None)
            for oid in spec.return_ids():
                self._return_to_task.pop(oid.binary(), None)
            return False
        hop = getattr(spec, "_hop", None)
        if hop is not None:
            # the C++ encode stamped the ring-enqueue time inside the entry
            # (pop returns the residency); this side closes submit_encode.
            # enq_ns doubles as the observed-once marker: a retry of this
            # spec re-entering via the Python queue must not re-fold the
            # failed attempt into submit_encode
            now = time.monotonic_ns()
            if "enq_ns" not in hop:
                hops.observe_ns("submit_encode", now - hop["sub_ns"])
            hop["enq_ns"] = now
        # always on the loop thread (inline fast lane or the xthread drain)
        self._ensure_push_feeders(key, spec)
        return True

    def _spawn_tracked_submit(self, spec: TaskSpec, coro):
        if self._closed:
            coro.close()
            self._fail_task(spec, RayTpuError("core worker closed"))
            return
        atask = spawn(self._guard_submit(spec, coro))
        self._track_submission(spec, atask)

    def submit_actor_task_nowait(self, actor_id: bytes, method_name: str,
                                 args: tuple, kwargs: dict,
                                 num_returns: int = 1,
                                 max_task_retries: int = 0,
                                 stream_backpressure: int = -1,
                                 concurrency_group: str = "",
                                 concurrent: bool = False):
        """NON-BLOCKING actor submission from ANY thread: args serialize
        on the calling thread (errors raise at the .remote() call site,
        before a sequence slot is taken), the sequence number is assigned
        under the lock (ordering is decided here), and delivery continues
        on the event loop. This is the `.remote()` hot path — a driver
        thread must not round-trip through the loop per call (that
        serializes "async" submission behind a thread hop and caps
        pipelined throughput at the hop rate; same design as
        submit_task_fast for plain tasks)."""
        wire_args, pyrefs, pending = self.serialize_args_sync(args, kwargs)
        st = self._actor_state(actor_id)
        if concurrent:
            st.concurrent = True
        with self._lock:
            seq = self._next_seq(st)
            # the task id must NOT derive from `seq`: sequence numbering
            # restarts at 1 for every actor incarnation, so a post-restart
            # task would reuse a pre-restart task's id — colliding in the
            # executor's duplicate-reply cache (a new call answered with a
            # stale cached reply) and in this owner's submission/return
            # tables. Mint from the caller-global task counter instead;
            # seq stays purely an ordering stamp. (Found by the chaos
            # harness: soak scenario 4, control-store stall during
            # failover.)
            self._task_index += 1
            task_index = self._task_index
        task_id = TaskID.for_actor_task(
            self.job_id, ActorID(actor_id), self.current_task_id, task_index
        )
        spec = TaskSpec(
            trace_ctx=_trace_inject(),
            task_id=task_id,
            job_id=self.job_id,
            kind=pb.TASK_KIND_ACTOR_TASK,
            method_name=method_name,
            args=wire_args,
            num_returns=num_returns,
            owner_worker_id=self.worker_id.binary(),
            owner_address=self.address,
            actor_id=ActorID(actor_id),
            seq_no=seq,
            incarnation=st.incarnation,
            name=method_name,
            stream_backpressure=stream_backpressure,
            concurrency_group=concurrency_group,
        )
        refs = [
            ObjectRef(oid, self.address, self.worker_id.binary())
            for oid in spec.return_ids()
        ]
        if spec.is_streaming:
            self._streams[task_id.binary()] = StreamState(task_id.binary())

        async def finish():
            for oid, sobj in pending:
                await self._complete_put(oid, sobj)
            await self._submit_actor_with_retries(st, spec, max_task_retries, pyrefs)

        guarded = self._guard_submit(spec, finish())
        if self._loop_running_here():
            atask = spawn(guarded)
        else:
            # foreign (driver) thread: hand off without waiting; the
            # concurrent.Future supports the same cancel/done-callback
            # surface _track_submission needs
            atask = asyncio.run_coroutine_threadsafe(guarded, self.loop)
        self._track_submission(spec, atask)
        if spec.is_streaming:
            return ObjectRefGenerator(self, task_id.binary())
        return refs

    async def _guard_submit(self, spec: TaskSpec, coro):
        """Serialization/export failures in a deferred submission must fail
        the returns, not vanish into the spawn error log."""
        try:
            await coro
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            if spec.kind == pb.TASK_KIND_ACTOR_TASK:
                # the sequence number was taken at submission but the spec
                # never reached the executor (e.g. unpicklable args): deliver
                # a cancelled tombstone so the slot is consumed — ordered
                # actors stall on sequence holes otherwise
                try:
                    spec.cancelled = True
                    spec.args = []
                    st = self._actor_state(spec.actor_id.binary())
                    await self._submit_actor_with_retries(st, spec, 0, [])
                except Exception:  # noqa: BLE001 — actor gone; no hole to fill
                    pass
            self._fail_task(spec, RayTpuError(f"submit failed: {e}"))

    def _track_submission(self, spec: TaskSpec, atask: asyncio.Task):
        tid = spec.task_id.binary()
        entry = {
            "state": "pending", "worker": "", "cancelled": False,
            "atask": atask, "spec": spec,
        }
        self._submissions[tid] = entry
        for oid in spec.return_ids():
            self._return_to_task[oid.binary()] = tid
        atask.add_done_callback(lambda _t: self._untrack_submission(spec))

    def _untrack_submission(self, spec: TaskSpec):
        self._submissions.pop(spec.task_id.binary(), None)
        for oid in spec.return_ids():
            self._return_to_task.pop(oid.binary(), None)

    def _fail_task(self, spec: TaskSpec, exc: Exception):
        """Resolve every return of a task (fixed or streaming) to an error."""
        for oid in spec.return_ids():
            self.memory_store.fail(oid.binary(), exc)
        if spec.is_streaming:
            self._stream_fail(spec.task_id.binary(), exc)

    def _stream_fail(self, tid: bytes, exc: Exception):
        """Terminate a stream with a trailing error item so iteration raises
        (at get of the final ref) instead of hanging."""
        st = self._streams.get(tid)
        if st is None or st.end is not None:
            return
        oid = ObjectID.for_task_return(TaskID(tid), st.produced)
        self.memory_store.fail(oid.binary(), exc)
        st.produced += 1
        st.end = st.produced
        st.wake_all()
        st.wake_consumers()

    async def _submit_with_retries(self, spec: TaskSpec, keepalive):
        from ray_tpu_torch._private.retry import RetryPolicy

        retries = spec.max_retries
        attempt = 0
        sub = None
        backoff = RetryPolicy(
            GLOBAL_CONFIG.get("retry_base_s"),
            GLOBAL_CONFIG.get("retry_max_s"),
        ).backoff()
        while True:
            sub = self._submissions.get(spec.task_id.binary())
            if sub is not None and sub["cancelled"]:
                self._fail_task(spec, TaskCancelledError(
                    f"task {spec.name or spec.function_key} was cancelled"))
                return
            try:
                await self._submit_once(spec)
                self._record_lineage(spec, keepalive)
                return
            except asyncio.CancelledError:
                # ray_tpu_torch.cancel() of a queued/leasing task cancels this
                # coroutine; resolve the returns so get() raises
                self._fail_task(spec, TaskCancelledError(
                    f"task {spec.name or spec.function_key} was cancelled"))
                raise
            except (WorkerCrashedError, RpcError, ConnectionError, asyncio.TimeoutError) as e:
                if sub is not None and sub["cancelled"]:
                    self._fail_task(spec, TaskCancelledError(
                        f"task {spec.name or spec.function_key} was cancelled"))
                    return
                attempt += 1
                if attempt > retries:
                    self._fail_task(
                        spec,
                        WorkerCrashedError(
                            f"task {spec.name or spec.function_key} failed after "
                            f"{retries} retries: {e}"
                        ),
                    )
                    return
                logger.info("retrying task %s (attempt %d): %s", spec.name, attempt, e)
                await backoff.sleep()
            except Exception as e:  # noqa: BLE001 — scheduling-level failure
                self._fail_task(spec, RayTpuError(f"submit failed: {e}"))
                return
        # `keepalive` pins arg refs for the life of this coroutine.

    async def _wait_args_ready(self, spec: TaskSpec):
        """Block until every by-reference arg is computed (reference:
        task_submission/dependency_resolver — the lease is requested only
        after dependencies resolve). Without this, a full complement of
        granted consumer tasks blocking on queued producer tasks deadlocks
        the worker pool."""

        async def one(a: dict):
            if self.owns_oid(a["owner_worker_id"]):
                await self.memory_store.wait_future(a["ref"])
            else:
                ref = ObjectRef(
                    ObjectID(a["ref"]), a["owner"], a["owner_worker_id"],
                    _register=False,
                )
                await self._call_owner(ref, "wait_object", {"object_id": a["ref"]})

        waits = [one(a) for a in spec.args if "ref" in a]
        if waits:
            await asyncio.gather(*waits)

    def owns_oid(self, owner_worker_id: bytes) -> bool:
        return owner_worker_id == self.worker_id.binary()

    def _lease_key(self, spec: TaskSpec) -> Optional[tuple]:
        return compute_lease_key(
            spec.resources, spec.strategy,
            (spec.runtime_env or {}).get("env_key", ""))

    def _pool_for(self, key: tuple) -> dict:
        pool = self._lease_pools.get(key)
        if pool is None:
            pool = self._lease_pools[key] = {
                "idle": [], "waiters": collections.deque(), "fetching": 0,
            }
        return pool

    async def _pool_lease(self, key: tuple, spec: TaskSpec) -> dict:
        """Take an idle cached lease, or register as a waiter while a
        detached fetcher requests a fresh one — a lease released by a
        finishing task is handed to the oldest waiter directly."""
        pool = self._pool_for(key)
        if pool["idle"]:
            return pool["idle"].pop()
        fut = self.loop.create_future()
        pool["waiters"].append(fut)
        # Bounded fetchers (reference: LeaseRequestRateLimiter): a burst of
        # N submissions must not flood the daemon with N lease requests —
        # recycled leases serve most waiters; fetchers only prime the pump.
        if pool["fetching"] < min(
            len(pool["waiters"]), GLOBAL_CONFIG.get("max_pending_lease_requests")
        ):
            pool["fetching"] += 1
            spawn(self._lease_fetch(key, spec))
        try:
            return await fut
        except asyncio.CancelledError:
            # Cancelled in the window after _lease_pool_put resolved this
            # future but before this coroutine resumed: the delivered lease
            # would otherwise be orphaned — never re-pooled, never returned —
            # permanently leaking that worker's capacity (advisor r2).
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                self._lease_pool_put(key, fut.result())
            else:
                try:
                    pool["waiters"].remove(fut)
                except ValueError:
                    pass
            raise

    async def _lease_fetch(self, key: tuple, spec: TaskSpec):
        try:
            lease = await self._acquire_lease(spec)
        except Exception as e:  # noqa: BLE001 — deliver the failure
            pool = self._lease_pools.get(key)
            if pool:
                pool["fetching"] = max(0, pool["fetching"] - 1)
            delivered = False
            while pool and pool["waiters"] and not delivered:
                fut = pool["waiters"].popleft()
                if not fut.done():
                    fut.set_exception(e)
                    delivered = True
            # each failure fails exactly one waiter; keep priming so the
            # REST eventually get a lease or their own failure instead of
            # hanging with fetching==0 and nothing recycling
            if pool and pool["waiters"] and pool["fetching"] < min(
                len(pool["waiters"]),
                GLOBAL_CONFIG.get("max_pending_lease_requests"),
            ):
                pool["fetching"] += 1
                spawn(self._lease_fetch(key, spec))
            return
        pool = self._lease_pools.get(key)
        if pool:
            pool["fetching"] = max(0, pool["fetching"] - 1)
            # keep priming while demand outstrips supply
            if pool["waiters"] and pool["fetching"] < min(
                len(pool["waiters"]),
                GLOBAL_CONFIG.get("max_pending_lease_requests"),
            ):
                pool["fetching"] += 1
                spawn(self._lease_fetch(key, spec))
        lease["fresh"] = True  # straight from the daemon, never executed on
        self._lease_pool_put(key, lease)

    def _lease_pool_put(self, key: tuple, lease: dict):
        pool = self._pool_for(key)
        while pool["waiters"]:
            fut = pool["waiters"].popleft()
            if not fut.done():
                fut.set_result(lease)
                return
        if len(pool["idle"]) >= GLOBAL_CONFIG.get("lease_pool_max_idle"):
            self.schedule(self._return_lease_quiet(
                lease["daemon_address"], lease["lease_id"]))
            return
        lease["idle_since"] = time.monotonic()
        pool["idle"].append(lease)

    async def _submit_once(self, spec: TaskSpec):
        await self._wait_args_ready(spec)
        key = self._lease_key(spec)
        if key is not None and not spec.is_streaming:
            # pipelined path: queue for a batch feeder (reference:
            # normal_task_submitter.h:226 pipelined PushNormalTask) — many
            # same-shaped tasks share one RPC to a leased worker
            await self._submit_via_queue(key, spec)
            return
        while True:
            if key is None:
                lease = await self._acquire_lease(spec)
                lease["fresh"] = True
            else:
                lease = await self._pool_lease(key, spec)
            # a recycled lease (another task already ran on its worker) can
            # be stale; only those get the transparent-refresh retry below
            cached = not lease.pop("fresh", False)
            worker_addr = lease["worker_address"]
            sub = self._submissions.get(spec.task_id.binary())
            if sub is not None:
                sub["state"] = "running"
                sub["worker"] = worker_addr
            try:
                client = await self._worker_client(worker_addr)
                reply = await client.call(
                    "push_task", {"spec": spec.to_wire()}, timeout=None)
            except (RpcError, ConnectionError) as e:
                # never reuse a lease whose worker just failed
                self.schedule(self._return_lease_quiet(
                    lease["daemon_address"], lease["lease_id"]))
                if cached:
                    # a cached lease can be stale (worker reaped, node died
                    # between tasks): siblings from the same daemon are
                    # equally dead — drop them all, then retry with a fresh
                    # lease rather than burning a task failure retry
                    self._drop_pooled_leases_from(lease["daemon_address"])
                    continue
                raise WorkerCrashedError(
                    f"worker at {worker_addr} died mid-task: {e}") from e
            except BaseException:
                # cancellation (ray_tpu_torch.cancel of this submit, close()) must
                # not strand the lease: the daemon would count the worker
                # leased forever (the pre-pool code's finally did this)
                self.schedule(self._return_lease_quiet(
                    lease["daemon_address"], lease["lease_id"]))
                raise
            # success: recycle the lease — next same-shaped task skips the
            # lease RPCs (reference: lease reuse + pipelining); the sweeper
            # returns it if nothing claims it in time
            if key is None:
                self.schedule(self._return_lease_quiet(
                    lease["daemon_address"], lease["lease_id"]))
            else:
                self._lease_pool_put(key, lease)
            self._record_task_reply(spec, reply)
            return

    async def _submit_via_queue(self, key: tuple, spec: TaskSpec):
        """Enqueue a ready spec for batched delivery; completes (or raises
        WorkerCrashedError into the caller's retry loop) when its batch's
        reply lands. One future per task — the feeder owns leases and RPCs."""
        q = self._push_queues.get(key)
        if q is None:
            q = self._push_queues[key] = collections.deque()
        self._hop_enqueue_stamp(spec)
        fut = self.loop.create_future()
        q.append((spec, fut))
        self._ensure_push_feeders(key, spec)
        try:
            await fut
        except asyncio.CancelledError:
            # the entry may still sit in the queue; feeders skip done futures
            if not fut.done():
                fut.cancel()
            raise

    def _ensure_push_feeders(self, key: tuple, spec: TaskSpec):
        q = self._push_queues.get(key)
        if not q and not self._fp_pending(key):
            return
        active = self._push_feeders.get(key, 0)
        # Every enqueue may add one feeder (up to the cap): existing feeders
        # are busy awaiting an in-flight batch, and a newly queued task must
        # be able to reach a DIFFERENT worker concurrently — otherwise one
        # slow task head-of-line-blocks tasks that have idle capacity
        # elsewhere. Surplus feeders exit as soon as the queue drains.
        if active < GLOBAL_CONFIG.get("push_feeders_per_key"):
            self._push_feeders[key] = active + 1
            spawn(self._push_feeder(key, spec))

    async def _push_feeder(self, key: tuple, template_spec: TaskSpec):
        """Drain the key's ready queue: take a lease, ship up to
        push_batch_max specs in ONE push_task_batch RPC, record replies,
        recycle the lease, repeat. Stale cached leases retry the whole batch
        transparently (not charged against task retries), exactly like the
        single-push path."""
        try:
            while True:
                q = self._push_queues.get(key)
                fp_n = self._fp_pending(key)
                if not q and not fp_n:
                    return
                try:
                    t_lease_ns = time.monotonic_ns()
                    lease = await self._pool_lease(key, template_spec)
                except Exception as e:  # noqa: BLE001 — lease unobtainable
                    # e.g. worker spawn failed (broken pip env): deliver the
                    # failure to ONE queued task (mirroring _lease_fetch's
                    # one-failure-one-waiter rule) instead of dying with the
                    # queue stranded
                    delivered = False
                    while q:
                        spec, fut = q.popleft()
                        if fut is None:
                            sub = self._submissions.get(spec.task_id.binary())
                            if sub is None:
                                continue
                            self._fail_task(spec, e)
                            self._untrack_submission(spec)
                            delivered = True
                            break
                        if not fut.done():
                            fut.set_exception(e)
                            delivered = True
                            break
                    if not delivered and fp_n and self._fastpath is not None:
                        # native-ring entries only: fail one of those instead
                        for handle, tid, _wait in self._fastpath.pop(
                                self._fp_rings[key], 1):
                            self._fastpath.entry_free(handle)
                            sub = self._submissions.get(tid)
                            if sub is not None:
                                self._fail_task(sub["spec"], e)
                                self._untrack_submission(sub["spec"])
                    continue
                cached = not lease.pop("fresh", False)
                grant_ns = lease.pop("grant_wait_ns", None)
                if not cached and hops.enabled():
                    # the grant hop: daemon-side queue-to-grant time when the
                    # reply carries it, else the owner-observed fetch wait
                    hops.observe_ns("grant", grant_ns if grant_ns is not None
                                    else time.monotonic_ns() - t_lease_ns)
                # fair share: don't let one feeder swallow the whole queue
                # into a single worker's (sequential) batch while sibling
                # feeders could drain it onto other workers in parallel
                qlen = (len(q) if q else 0) + fp_n
                maxb = max(1, min(
                    GLOBAL_CONFIG.get("push_batch_max"),
                    -(-qlen // max(1, self._push_feeders.get(key, 1))),
                ))
                if fp_n:
                    progressed = await self._push_fp_batch(
                        key, lease, cached, maxb, q)
                    if progressed:
                        continue
                    if not q:
                        self._lease_pool_put(key, lease)
                        continue
                batch = []
                while q and len(batch) < maxb:
                    spec, fut = q.popleft()
                    if fut is not None and fut.done():
                        continue  # cancelled while queued
                    sub = self._submissions.get(spec.task_id.binary())
                    if sub is not None and sub.get("cancelled"):
                        if fut is None:
                            # fast-lane entry: no coroutine resolves the
                            # returns — do it here
                            self._fail_task(spec, TaskCancelledError(
                                f"task {spec.name or spec.function_key} "
                                f"was cancelled"))
                            self._untrack_submission(spec)
                        else:
                            fut.cancel()
                        continue
                    batch.append((spec, fut))
                if not batch:
                    self._lease_pool_put(key, lease)
                    continue
                worker_addr = lease["worker_address"]
                traced = hops.enabled()
                if traced:
                    t_pop = time.monotonic_ns()
                    waits = [t_pop - s._hop["enq_ns"] for s, _ in batch
                             if getattr(s, "_hop", None)
                             and "enq_ns" in s._hop]
                    if waits:
                        hops.observe_many_ns("ring_wait", waits)
                for spec, fut in batch:
                    sub = self._submissions.get(spec.task_id.binary())
                    if sub is not None:
                        sub["state"] = "running"
                        sub["worker"] = worker_addr
                try:
                    client = await self._worker_client(worker_addr)
                    payload = {"specs": [s.to_wire() for s, _ in batch]}
                    if traced:
                        t_send = time.monotonic_ns()
                        hops.observe_ns("frame_build", t_send - t_pop)
                        t_send_wall = time.time()
                    reply = await client.call(
                        "push_task_batch", payload, timeout=None,
                    )
                    if traced:
                        t_reply = time.monotonic_ns()
                        if "srv_ns" in reply:
                            # srv_ns missing = the worker's tracing flag is
                            # off (runtime-enabled driver, pre-spawn
                            # worker): skip rather than fold the whole
                            # server-side execution into the wire hop
                            hops.observe_ns(
                                "wire_rtt",
                                t_reply - t_send - reply["srv_ns"])
                except (RpcError, ConnectionError) as e:
                    self.schedule(self._return_lease_quiet(
                        lease["daemon_address"], lease["lease_id"]))
                    if cached:
                        # stale cached lease (worker reaped between tasks):
                        # requeue at the front and retry with another lease
                        # rather than burning task retries
                        self._drop_pooled_leases_from(lease["daemon_address"])
                        for item in reversed(batch):
                            self._hop_enqueue_stamp(item[0])
                            q.appendleft(item)
                        continue
                    err = WorkerCrashedError(
                        f"worker at {worker_addr} died mid-task: {e}")
                    for spec, fut in batch:
                        if fut is None:
                            self._fast_lane_retry(key, q, spec, err)
                        elif not fut.done():
                            fut.set_exception(err)
                    continue
                except BaseException as e:
                    # close()/feeder cancellation mid-push: don't strand the
                    # lease or the waiting submissions
                    self.schedule(self._return_lease_quiet(
                        lease["daemon_address"], lease["lease_id"]))
                    err = WorkerCrashedError(f"submission aborted: {e}")
                    for spec, fut in batch:
                        if fut is None:
                            self._fail_task(spec, err)
                            self._untrack_submission(spec)
                        elif not fut.done():
                            fut.set_exception(err)
                    raise
                self._lease_pool_put(key, lease)
                for (spec, fut), r in zip(batch, reply["replies"]):
                    try:
                        self._record_task_reply(spec, r)
                    except Exception as e:  # noqa: BLE001 — per-task failure
                        if fut is None:
                            self._fail_task(spec, e)
                            self._untrack_submission(spec)
                        elif not fut.done():
                            fut.set_exception(e)
                        continue
                    if traced and getattr(spec, "_hop", None) is not None:
                        self._note_hop_spans(spec, r, t_send_wall)
                    if fut is None:
                        sub = self._submissions.get(spec.task_id.binary())
                        self._record_lineage(
                            spec, sub["keepalive"] if sub else [])
                        self._untrack_submission(spec)
                    elif not fut.done():
                        fut.set_result(None)
                if traced:
                    hops.observe_ns("completion",
                                    time.monotonic_ns() - t_reply)
        finally:
            n = self._push_feeders.get(key, 1) - 1
            if n <= 0:
                self._push_feeders.pop(key, None)
            else:
                self._push_feeders[key] = n
            # a task enqueued in the window after this feeder saw an empty
            # queue must not wait forever
            self._ensure_push_feeders(key, template_spec)

    async def _push_fp_batch(self, key: tuple, lease: dict, cached: bool,
                             maxb: int, q) -> bool:
        """Drain up to `maxb` native-ring entries into ONE preassembled
        push_task_batch frame shipped to the leased worker (the C++ engine
        concatenates the pre-encoded specs and the frame header into a
        single buffer — one write, no per-spec packing). Returns True when
        this iteration made progress (sent a batch or consumed cancelled
        entries); False when the ring turned out empty (a sibling feeder
        won the race) — the caller still owns the lease."""
        eng = self._fastpath
        ring = self._fp_rings[key]
        popped = eng.pop(ring, maxb)
        if not popped:
            return False
        traced = hops.enabled()
        if traced:
            # ring residency stamped by the C++ engine at encode time
            hops.observe_many_ns("ring_wait", [w for _h, _t, w in popped])
        handles, specs = [], []
        for handle, tid, _wait in popped:
            sub = self._submissions.get(tid)
            if sub is None or sub.get("cancelled"):
                eng.entry_free(handle)
                if sub is not None:
                    spec = sub["spec"]
                    self._fail_task(spec, TaskCancelledError(
                        f"task {spec.name or spec.function_key} "
                        f"was cancelled"))
                    self._untrack_submission(spec)
                continue
            handles.append(handle)
            specs.append(sub["spec"])
        if not handles:
            self._lease_pool_put(key, lease)
            return True
        worker_addr = lease["worker_address"]
        for spec in specs:
            sub = self._submissions.get(spec.task_id.binary())
            if sub is not None:
                sub["state"] = "running"
                sub["worker"] = worker_addr

        consumed = [False]  # build() owns the entries once entered
        t_sent = [0]

        def build(req_id: int) -> bytes:
            consumed[0] = True
            t0 = time.monotonic_ns() if traced else 0
            frame = eng.build_frame(handles, req_id)
            if frame is None:  # over the transport limit (absurd batch)
                for h in handles:
                    eng.entry_free(h)
                raise RpcError("fastpath batch frame exceeds transport limit")
            if traced:
                t_sent[0] = time.monotonic_ns()
                hops.observe_ns("frame_build", t_sent[0] - t0)
            return frame

        def free_unconsumed():
            # a failure BEFORE build() ran (dead worker at connect, client
            # closed, cancellation) leaves the popped entries ours to free
            if not consumed[0]:
                for h in handles:
                    eng.entry_free(h)

        try:
            client = await self._worker_client(worker_addr)
            reply = await client.call_frame(build, timeout=None)
            if traced:
                t_reply = time.monotonic_ns()
                if "srv_ns" in reply:
                    # see the Python-batch site: a tracing-off worker's
                    # reply carries no srv_ns — skip, don't absorb exec time
                    hops.observe_ns(
                        "wire_rtt", t_reply - t_sent[0] - reply["srv_ns"])
        except (RpcError, ConnectionError) as e:
            free_unconsumed()
            self.schedule(self._return_lease_quiet(
                lease["daemon_address"], lease["lease_id"]))
            if q is None:
                q = self._push_queues.setdefault(key, collections.deque())
            if cached:
                # stale cached lease (worker reaped between tasks): retry
                # transparently — the encoded entries are gone (freed or
                # consumed), so the retry rides the Python queue
                self._drop_pooled_leases_from(lease["daemon_address"])
                for spec in reversed(specs):
                    self._hop_enqueue_stamp(spec)
                    q.appendleft((spec, None))
            else:
                err = WorkerCrashedError(
                    f"worker at {worker_addr} died mid-task: {e}")
                for spec in specs:
                    self._fast_lane_retry(key, q, spec, err)
            return True
        except BaseException as e:
            # close()/feeder cancellation mid-push: don't strand the lease,
            # the native entries, or the waiting submissions
            free_unconsumed()
            self.schedule(self._return_lease_quiet(
                lease["daemon_address"], lease["lease_id"]))
            err = WorkerCrashedError(f"submission aborted: {e}")
            for spec in specs:
                self._fail_task(spec, err)
                self._untrack_submission(spec)
            raise
        self._lease_pool_put(key, lease)
        for spec, r in zip(specs, reply["replies"]):
            try:
                self._record_task_reply(spec, r)
            except Exception as e:  # noqa: BLE001 — per-task failure
                self._fail_task(spec, e)
                self._untrack_submission(spec)
                continue
            sub = self._submissions.get(spec.task_id.binary())
            self._record_lineage(spec, sub["keepalive"] if sub else [])
            self._untrack_submission(spec)
        if traced:
            hops.observe_ns("completion", time.monotonic_ns() - t_reply)
        return True

    def _fast_lane_retry(self, key: tuple, q: collections.deque,
                         spec: TaskSpec, err: Exception):
        """Feeder-side retry bookkeeping for fast-lane submissions (no
        per-task coroutine to re-run): requeue until the spec's retry budget
        is spent, then fail the returns."""
        sub = self._submissions.get(spec.task_id.binary())
        if sub is None:
            return
        if sub.get("cancelled"):
            self._fail_task(spec, TaskCancelledError(
                f"task {spec.name or spec.function_key} was cancelled"))
            self._untrack_submission(spec)
            return
        sub["attempts"] = sub.get("attempts", 0) + 1
        if sub["attempts"] > spec.max_retries:
            self._fail_task(spec, WorkerCrashedError(
                f"task {spec.name or spec.function_key} failed after "
                f"{spec.max_retries} retries: {err}"))
            self._untrack_submission(spec)
            return
        sub["state"] = "pending"
        sub["worker"] = ""
        self._hop_enqueue_stamp(spec)
        q.append((spec, None))

    def _drop_pooled_leases_from(self, daemon_address: str):
        """A worker from `daemon_address` just failed: every cached lease
        from that daemon is suspect (node death kills them all at once)."""
        for pool in self._lease_pools.values():
            suspect = [
                lease for lease in pool["idle"]
                if lease["daemon_address"] == daemon_address
            ]
            if suspect:
                pool["idle"] = [
                    lease for lease in pool["idle"] if lease not in suspect
                ]
                for lease in suspect:
                    self.schedule(self._return_lease_quiet(
                        daemon_address, lease["lease_id"]))

    async def _lease_pool_sweep(self):
        """Return leases idle past worker_lease_idle_s so cached capacity
        doesn't starve other drivers (reference: lease idle timeout)."""
        period = GLOBAL_CONFIG.get("worker_lease_idle_s")
        while not self._closed:
            await asyncio.sleep(period / 2)
            cutoff = time.monotonic() - period
            for key, pool in list(self._lease_pools.items()):
                keep = []
                for lease in pool["idle"]:
                    if lease["idle_since"] < cutoff:
                        spawn(self._return_lease_quiet(
                            lease["daemon_address"], lease["lease_id"]))
                    else:
                        keep.append(lease)
                pool["idle"] = keep
                if not keep and not pool["waiters"]:
                    self._lease_pools.pop(key, None)

    def _note_hop_spans(self, spec: TaskSpec, reply: dict,
                        t_send_wall: float):
        """Fold one EXPLICITLY-traced task's hop stamps into span records so
        timeline() shows the call split into its hops (root-sentinel tasks
        fold into the rt_task_hop_seconds histograms only — per-task span
        records at 100k/s would be their own overhead)."""
        ctx = spec.trace_ctx
        if not isinstance(ctx, dict) or not ctx.get("trace_id"):
            return
        hop = getattr(spec, "_hop", None)
        if hop is None or "enq_ns" not in hop:
            return
        from ray_tpu_torch.util import tracing

        wall0 = hop["wall0"]
        enq_wall = wall0 + (hop["enq_ns"] - hop["sub_ns"]) / 1e9
        segments = [("hop:submit", wall0, enq_wall),
                    ("hop:queue", enq_wall, t_send_wall)]
        whops = reply.get("hops") or {}
        recv = whops.get("recv")
        end = whops.get("end")
        if recv:
            segments.append(("hop:flight", t_send_wall, recv))
            if whops.get("start"):
                segments.append(("hop:exec_wait", recv, whops["start"]))
        if end:
            segments.append(("hop:reply", end, time.time()))
        for name, start, stop in segments:
            tracing.record_span({
                "trace_id": ctx["trace_id"],
                "span_id": os.urandom(8).hex(),
                "parent_span_id": ctx.get("parent_span_id", ""),
                "name": name, "start": start, "end": max(start, stop),
            }, task_id=spec.task_id.binary())

    def _record_task_reply(self, spec: TaskSpec, reply: dict):
        sub = self._submissions.get(spec.task_id.binary())
        if (sub is not None and sub.get("cancelled") and all(
                oid.binary() in self.memory_store.objects
                for oid in spec.return_ids())):
            # cancelled with returns already resolved to TaskCancelledError:
            # drop the stale reply from the interrupted (or completed-late)
            # execution instead of overwriting the cancellation
            return
        if reply.get("error"):
            err = reply["error"]
            exc = TaskError(
                spec.name or spec.function_key, err.get("traceback", ""),
            )
            if err.get("pickled"):
                try:
                    exc = self._deserialize_error(err["pickled"])
                except Exception:  # noqa: BLE001
                    pass
            self._fail_task(spec, exc)
            return
        if spec.is_streaming:
            # items flowed via report_stream_item; the final reply closes the
            # stream (backup in case the last report raced the reply)
            self._stream_end(spec.task_id.binary(), reply.get("stream_end", 0))
            return
        for ret in reply["returns"]:
            self._record_return_entry(ret)

    # ------------------------------------------------------------------
    # lineage reconstruction — delegated to the recovery manager
    # (reference: object_recovery_manager.h; see _private.recovery for the
    # per-object state machine and the authoritative-death trigger)
    # ------------------------------------------------------------------

    def _record_lineage(self, spec: TaskSpec, keepalive):
        self.recovery.record_lineage(spec, keepalive)

    async def rpc_reconstruct_object(self, conn_id: int, payload: dict) -> dict:
        """A borrower observed the object's store node die; recover it."""
        ok = await self.recovery.recover(
            payload["object_id"], payload.get("failed_node")
        )
        return {"ok": ok} if ok else {"ok": False, "error": "no lineage for object"}

    async def _acquire_lease(self, spec: TaskSpec) -> dict:
        address = self.daemon_address
        hops = 0
        last_warn = 0.0
        # stable per-logical-request key: retries after a dropped/timed-out
        # call attach to the daemon's original (possibly still queued)
        # request instead of double-granting
        request_key = os.urandom(16)
        while True:
            try:
                client = await self._owner_client(address)
            except (RpcConnectionLost, ConnectionError, OSError):
                if address != self.daemon_address:
                    # spillback target died before gossip caught up: route
                    # back through the local daemon rather than failing the
                    # submit (it re-picks from the refreshed view)
                    address = self.daemon_address
                    hops = 0
                    await asyncio.sleep(0.2)
                    continue
                raise
            payload = {
                "resources": spec.resources.to_wire(),
                "strategy": spec.strategy.to_wire(),
                "job_id": self.job_id.binary(),
                "hops": hops,
                "request_key": request_key,
            }
            if (spec.runtime_env or {}).get("env_key"):
                # isolating env (pip venv / working_dir): the daemon must
                # grant a worker built for exactly this env
                payload["runtime_env"] = spec.runtime_env
            inner = spawn(self._lease_call_with_deadline(client, payload))
            try:
                reply = await asyncio.shield(inner)
            except asyncio.CancelledError:
                # ray_tpu_torch.cancel() of a queued task: the daemon may still
                # grant this request later — return that orphan lease so its
                # resources don't leak
                inner.add_done_callback(
                    functools.partial(self._return_orphan_lease, address)
                )
                raise
            except (RpcConnectionLost, ConnectionError):
                # connection-level loss ONLY: a server-side error reply must
                # still propagate (rerouting it would loop forever against a
                # healthy-but-erroring daemon)
                if address != self.daemon_address:
                    # spillback daemon died mid-call: reroute via local.
                    # It may have granted just before the blip — request_key
                    # idempotency is per-daemon, so the rerouted request
                    # would double-grant and leak the first worker forever
                    # (advisor r2). Best-effort release of the possible
                    # orphan, and a fresh key so a future spillback back to
                    # this daemon can't attach to the released grant.
                    spawn(self._cancel_lease_request_quiet(
                        address, request_key))
                    request_key = os.urandom(16)
                    address = self.daemon_address
                    hops = 0
                    await asyncio.sleep(0.2)
                    continue
                raise
            if reply.get("granted"):
                reply["daemon_address"] = address
                return reply
            if reply.get("spillback"):
                address = reply["spillback"]
                hops += 1
                continue
            if reply.get("infeasible"):
                # The reference keeps infeasible work queued — a node with the
                # right resources may join (autoscaling, gossip lag). Warn
                # periodically and retry.
                now = time.monotonic()
                if now - last_warn > 30:
                    last_warn = now
                    logger.warning(
                        "task %s requires resources %s which no live node "
                        "currently provides; waiting",
                        spec.name or spec.function_key, spec.resources.to_dict(),
                    )
                await asyncio.sleep(0.5)
                address = self.daemon_address
                hops = 0
                continue
            if reply.get("retry"):
                await asyncio.sleep(0.2)
                address = self.daemon_address
                # fresh routing attempt: without this, spillback→retry cycles
                # accumulate hops to the cap and the local daemon then queues
                # the lease locally even when only a remote node can host it
                hops = 0
                continue
            if reply.get("infeasible_in_pg"):
                # permanent: the request exceeds the bundle's TOTAL
                # reservation and can never be granted — fail loudly
                raise RayTpuError(
                    f"task {spec.name or spec.function_key} can never be "
                    f"placed: {reply.get('error')}")
            raise RayTpuError(f"lease request failed: {reply}")

    async def _lease_call_with_deadline(self, client, payload: dict) -> dict:
        """request_lease with a per-attempt deadline, retried forever: the
        lease may legitimately stay queued on a busy daemon (the reference
        holds RequestWorkerLease open indefinitely), while a dropped call is
        recovered after one deadline because the request_key makes retries
        idempotent (daemon coalesces them onto the original request)."""
        deadline_s = GLOBAL_CONFIG.get("lease_request_timeout_s")
        while True:
            try:
                return await client.call("request_lease", payload,
                                         timeout=deadline_s)
            except asyncio.TimeoutError:
                await asyncio.sleep(0.05)
            except RpcError as e:
                # timeouts mean the lease is (still) queued — keep waiting.
                # Connection-level failures mean the daemon is gone and must
                # propagate so _submit_with_retries re-routes/fails the task.
                if isinstance(e.__cause__, asyncio.TimeoutError):
                    await asyncio.sleep(0.05)
                    continue
                raise

    async def _cancel_lease_request_quiet(
        self, daemon_address: str, request_key: bytes
    ):
        """Ask `daemon_address` to release whatever lease it may have granted
        under `request_key` (the connection died mid-request_lease and the
        caller rerouted, so a grant would never be claimed). Best-effort with
        brief retries — the daemon was reachable moments ago and connection
        blips heal; if it truly died, its leases die with it."""
        for _ in range(5):
            try:
                client = await self._owner_client(daemon_address)
                await client.call(
                    "cancel_lease_request",
                    {"request_key": request_key}, timeout=5.0)
                return
            except Exception:  # noqa: BLE001 — best-effort
                await asyncio.sleep(0.5)

    def _return_orphan_lease(self, daemon_address: str, t: asyncio.Task):
        if t.cancelled() or t.exception() is not None:
            return
        reply = t.result()
        if reply.get("granted"):
            self.schedule(self._return_lease_quiet(daemon_address, reply["lease_id"]))

    async def _return_lease_quiet(self, daemon_address: str, lease_id,
                                  deadline: Optional[float] = None):
        try:
            client = await self._owner_client(daemon_address)
            await client.call("return_lease", {"lease_id": lease_id},
                              timeout=5, deadline=deadline)
        except Exception:  # noqa: BLE001 — daemon may be gone
            pass

    async def _worker_client(self, address: str) -> RpcClient:
        client = self._worker_clients.get(address)
        if client is None:
            client = RpcClient(address, name="to-worker", retries=0)
            await client.connect()
            self._worker_clients[address] = client
        return client

    # ------------------------------------------------------------------
    # compiled-graph channel plane (reference: experimental/channel/
    # torch_tensor_accelerator_channel.py — cross-node channel endpoints)
    # ------------------------------------------------------------------

    def register_dag_channel(self, dag_id: str, edge: str, chan) -> None:
        """Expose a locally-created ring so cross-node writers can reach it
        through rpc_chan_write. Called from the reader's executor thread."""
        self._dag_channels[(dag_id, edge)] = chan

    def unregister_dag_channel(self, dag_id: str, edge: str) -> None:
        self._dag_channels.pop((dag_id, edge), None)
        self._dag_channel_locks.pop((dag_id, edge), None)
        self._dag_channel_seqs.pop((dag_id, edge), None)

    async def quiesce_dag_channel(self, dag_id: str, edge: str) -> None:
        """Teardown half of the rpc_chan_write race fix: unregister the
        edge AFTER draining its per-edge lock, so no in-flight write still
        holds the chan when the caller unpins the ring (the ring must be
        close()d first so a blocked writer fails fast instead of holding
        the lock until its timeout)."""
        key = (dag_id, edge)
        lock = self._dag_channel_locks.get(key)
        if lock is not None:
            async with lock:
                self.unregister_dag_channel(dag_id, edge)
        else:
            self.unregister_dag_channel(dag_id, edge)

    async def rpc_chan_write(self, conn_id: int, payload: dict) -> dict:
        """Write one slot into a ring this process reads (the cross-node
        half of a compiled-graph edge). Per-edge FIFO lock keeps slot order
        equal to RPC arrival order even though writes block in a thread.

        `seq` is the writer's per-edge slot counter and makes the write
        IDEMPOTENT: the RPC client retries on lost connections, and a
        retry of a write the ring already took must not land a second
        copy (a duplicate slot would shift every later execution's value
        on that edge). An edge has exactly one writer (SPSC), so a simple
        last-applied watermark suffices."""
        key = (payload["dag_id"], payload["edge"])
        deadline = time.monotonic() + float(payload.get("open_timeout", 15))
        while key not in self._dag_channels:
            # the reader registers at executor-loop start; a writer racing
            # ahead of it parks here rather than failing the edge
            if time.monotonic() >= deadline:
                return {"error": "no_such_channel"}
            await asyncio.sleep(0.02)
        lock = self._dag_channel_locks.get(key)
        if lock is None:
            lock = self._dag_channel_locks[key] = asyncio.Lock()
        chan = self._dag_channels[key]
        timeout = payload.get("timeout")
        seq = payload.get("seq")
        async with lock:
            # re-check under the lock: teardown may have unregistered the
            # edge between the lookup above and acquiring the lock — writing
            # into an unpinned ring is silent shm corruption (ADVICE r5 #3)
            if self._dag_channels.get(key) is not chan:
                return {"error": "no_such_channel"}
            if seq is not None and seq <= self._dag_channel_seqs.get(key, -1):
                return {"ok": True, "duplicate": True}
            try:
                await asyncio.to_thread(
                    chan.write_bytes, payload["payload"],
                    None if timeout is None else float(timeout))
            except TimeoutError:
                return {"error": "full"}
            except EOFError:
                # ring closed by the reader (teardown): fail fast
                return {"error": "closed"}
            except ValueError as exc:  # oversized payload
                return {"error": f"value:{exc}"}
            if seq is not None:
                self._dag_channel_seqs[key] = seq
        return {"ok": True}

    # ------------------------------------------------------------------
    # actors (reference: actor_task_submitter.h:69, gcs_actor_manager.h:94)
    # ------------------------------------------------------------------

    _ACTOR_STATE_RANK = {
        pb.ACTOR_PENDING: 0, pb.ACTOR_RESTARTING: 1,
        pb.ACTOR_ALIVE: 2, pb.ACTOR_DEAD: 3,
    }

    def _on_actor_update(self, message: dict):
        st = self._actor_states.get(message["actor_id"])
        if st is None:
            return
        # per-restart-cycle monotonic version: PENDING(0) < RESTARTING(n) <
        # ALIVE(n) < DEAD(n). Poll replies and pubsub pushes interleave
        # without ordering; applying a stale one must never regress state
        # (it would fabricate an incarnation and poison seq numbering).
        version = (message.get("num_restarts", 0),
                   self._ACTOR_STATE_RANK.get(message["state"], 0))
        if version < st.applied_version:
            return
        st.applied_version = version
        st.state = message["state"]
        st.death_cause = message.get("death_cause", "")
        if st.state == pb.ACTOR_ALIVE:
            if st.address != message["worker_address"]:
                if st.client is not None:
                    old = st.client
                    st.client = None
                    self.schedule(old.close())
                st.address = message["worker_address"]
                if st.ever_alive:
                    # replacement worker process = fresh incarnation: its
                    # executor expects seq to restart at 1
                    st.incarnation += 1
                    st.seq = 0
            st.ever_alive = True
        elif st.state in (pb.ACTOR_RESTARTING, pb.ACTOR_DEAD):
            st.address = ""
            if st.client is not None:
                old = st.client
                st.client = None
                self.schedule(old.close())
            if st.state == pb.ACTOR_DEAD:
                st.creation_keepalive = []
        if st.event is not None:
            st.event.set()

    def _actor_state(self, actor_id: bytes) -> ActorHandleState:
        st = self._actor_states.get(actor_id)
        if st is None:
            st = ActorHandleState(actor_id)
            st.event = asyncio.Event()
            self._actor_states[actor_id] = st
        return st

    async def create_actor(
        self,
        class_key: str,
        args: tuple,
        kwargs: dict,
        resources: Optional[Dict[str, float]] = None,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        max_concurrency: int = 1,
        is_async: bool = False,
        strategy: Optional[SchedulingStrategy] = None,
        name: str = "",
        namespace: str = "",
        detached: bool = False,
        runtime_env: Optional[dict] = None,
        concurrency_groups: Optional[Dict[str, int]] = None,
        method_meta: Optional[Dict[str, dict]] = None,
        drain_cooperative: bool = False,
    ) -> ActorID:
        with self._lock:
            self._actor_index += 1
            actor_id = ActorID.of(self.job_id, self.current_task_id, self._actor_index)
        await self._register_actor_with_id(
            actor_id, class_key, args, kwargs,
            resources=resources, max_restarts=max_restarts,
            max_task_retries=max_task_retries, max_concurrency=max_concurrency,
            is_async=is_async, strategy=strategy, name=name,
            namespace=namespace, detached=detached, runtime_env=runtime_env,
            concurrency_groups=concurrency_groups, method_meta=method_meta,
            drain_cooperative=drain_cooperative,
        )
        return actor_id

    def create_actor_nowait(self, class_obj, class_key: str, args: tuple,
                            kwargs: dict, **ctor_opts) -> ActorID:
        """Loop-thread-safe actor creation (from inside async actors):
        allocate the id synchronously, register in a spawned task. Callers
        interact through the handle; method submissions wait for ALIVE."""
        with self._lock:
            self._actor_index += 1
            actor_id = ActorID.of(self.job_id, self.current_task_id, self._actor_index)
        st = self._actor_state(actor_id.binary())

        async def finish():
            try:
                await self.export_function(class_key, class_obj)
                await self._register_actor_with_id(
                    actor_id, class_key, args, kwargs, **ctor_opts
                )
            except Exception as e:  # noqa: BLE001 — surface via actor state
                st.state = pb.ACTOR_DEAD
                st.death_cause = f"actor registration failed: {e}"
                if st.event is not None:
                    st.event.set()

        spawn(finish())
        return actor_id

    async def _register_actor_with_id(
        self,
        actor_id: ActorID,
        class_key: str,
        args: tuple,
        kwargs: dict,
        resources: Optional[Dict[str, float]] = None,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        max_concurrency: int = 1,
        is_async: bool = False,
        strategy: Optional[SchedulingStrategy] = None,
        name: str = "",
        namespace: str = "",
        detached: bool = False,
        runtime_env: Optional[dict] = None,
        concurrency_groups: Optional[Dict[str, int]] = None,
        method_meta: Optional[Dict[str, dict]] = None,
        drain_cooperative: bool = False,
    ) -> None:
        from ray_tpu_torch._private.runtime_env_mgr import prepare_runtime_env

        runtime_env = await prepare_runtime_env(runtime_env, self)
        wire_args = await self.serialize_args(args, kwargs)
        pyrefs = [a.pop("_pyref") for a in wire_args if "_pyref" in a]
        spec = TaskSpec(
            trace_ctx=_trace_inject(),
            task_id=TaskID.for_actor_creation(actor_id),
            job_id=self.job_id,
            kind=pb.TASK_KIND_ACTOR_CREATION,
            function_key=class_key,
            args=wire_args,
            resources=ResourceSet(resources if resources is not None else {"CPU": 1.0}),
            strategy=strategy or SchedulingStrategy(),
            owner_worker_id=self.worker_id.binary(),
            owner_address=self.address,
            actor_id=actor_id,
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            is_async_actor=is_async,
            concurrency_groups=dict(concurrency_groups or {}),
            method_meta=dict(method_meta or {}),
            runtime_env={**(runtime_env or {}), "namespace": namespace,
                         "detached": detached},
            name=name,
            drain_cooperative=drain_cooperative,
        )
        self._actor_state(actor_id.binary()).creation_keepalive = pyrefs
        await self.control.call("register_actor", {"spec": spec.to_wire()})

    async def wait_actor_alive(self, actor_id: bytes,
                               timeout: Optional[float] = None):
        st = self._actor_state(actor_id)
        if timeout is None:
            # track the control store's creation budget (plus margin for its
            # retries) — a caller giving up before the scheduler does turns
            # recoverable delays into spurious ActorUnavailableErrors
            timeout = GLOBAL_CONFIG.get("actor_creation_timeout_s") + 30.0
        deadline = time.monotonic() + timeout
        while st.state != pb.ACTOR_ALIVE:
            if st.state == pb.ACTOR_DEAD:
                raise ActorDiedError(f"actor failed to start: {st.death_cause}")
            # poll as fallback for missed pubsub
            reply = await self.control.call("get_actor_info", {"actor_id": actor_id})
            if reply["actor"]:
                self._on_actor_update(reply["actor"])
            if st.state == pb.ACTOR_ALIVE:
                break
            if time.monotonic() > deadline:
                raise ActorUnavailableError("timed out waiting for actor to start")
            await asyncio.sleep(0.1)

    async def submit_actor_task(self, actor_id: bytes, method_name: str,
                                args: tuple, kwargs: dict, **opts):
        """Thin async shim over the one real submission path (the nowait
        one) — kept for API compatibility; a second seq-minting path would
        have to stay lock-consistent with it for nothing."""
        return self.submit_actor_task_nowait(
            actor_id, method_name, args, kwargs, **opts)

    def _next_seq(self, st: ActorHandleState) -> int:
        st.seq += 1
        return st.seq

    async def _submit_actor_with_retries(self, st: ActorHandleState, spec: TaskSpec,
                                         max_task_retries: int, keepalive):
        try:
            await self._submit_actor_with_retries_inner(
                st, spec, max_task_retries, keepalive)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — e.g. ObjectLostError from args
            # exceptions outside the inner loop's handled set: the caller's
            # refs must resolve (not hang), and the executor's sequence slot
            # must be tombstoned or later seqs eat the ordering-gap timeout
            self._fail_task(spec, e if isinstance(e, RayTpuError)
                            else RayTpuError(f"actor submit failed: {e}"))
            spec.cancelled = True
            self.schedule(self._push_tombstone_quiet(st, spec))
        finally:
            # catch-all: a spec that terminally failed BEFORE its push (args
            # lost, cancellation, actor death) must still release its push
            # turn or every later sequence number blocks forever
            self._release_push_turn(st, spec)

    async def _push_tombstone_quiet(self, st: ActorHandleState, spec: TaskSpec):
        """Best-effort delivery of a cancelled tombstone so the executor's
        sequence window advances past a terminally-failed spec."""
        try:
            await self.wait_actor_alive(st.actor_id, timeout=30)
            if st.client is None:
                st.client = RpcClient(st.address, name="to-actor", retries=0)
                await st.client.connect()
            await self._actor_push(st, spec)
        except Exception:  # noqa: BLE001 — the gap timeout is the fallback
            pass

    async def _submit_actor_with_retries_inner(
            self, st: ActorHandleState, spec: TaskSpec,
            max_task_retries: int, keepalive):
        attempt = 0
        while True:
            sub = self._submissions.get(spec.task_id.binary())
            if sub is not None and sub["cancelled"]:
                # Push a tombstone instead of dropping the spec: its sequence
                # slot must advance on the executor or every later task from
                # this caller stalls on the hole (ordered actors never
                # reorder). The executor replies TaskCancelledError without
                # running the method.
                spec.cancelled = True
            try:
                # resolve dependencies before delivery: an actor slot blocked
                # on a queued producer would stall the whole ordered queue
                await self._wait_args_ready(spec)
                await self.wait_actor_alive(st.actor_id)
                if spec.incarnation != st.incarnation:
                    # the actor restarted since this spec was stamped: its
                    # fresh executor numbers from 1, so re-stamp into the
                    # current incarnation's sequence (order across a crash is
                    # best-effort, as in the reference's restart epoch).
                    # _next_seq under the lock: driver threads mint seqs
                    # concurrently via submit_actor_task_nowait
                    spec.incarnation = st.incarnation
                    with self._lock:
                        spec.seq_no = self._next_seq(st)
                if st.client is None:
                    st.client = RpcClient(st.address, name="to-actor", retries=0)
                    await st.client.connect()
                client = st.client
                if sub is not None:
                    if sub["cancelled"]:
                        spec.cancelled = True  # flag set while waiting above
                    sub["state"] = "running"
                    sub["worker"] = st.address
                reply = await self._actor_push(st, spec)
                self._record_task_reply(spec, reply)
                return
            except asyncio.CancelledError:
                self._fail_task(spec, TaskCancelledError(
                    f"actor task {spec.method_name} was cancelled"))
                raise
            except _ActorRestartedWhileQueued:
                # parked in the push queue across a restart: loop to restamp
                # into the new incarnation (never delivered — does not
                # consume a user retry; bounded by actual restarts)
                continue
            except (ActorDiedError, ActorUnavailableError) as e:
                self._fail_task(spec, e)
                return
            except (RpcError, ConnectionError, asyncio.TimeoutError) as e:
                if sub is not None and sub["cancelled"]:
                    self._fail_task(spec, TaskCancelledError(
                        f"actor task {spec.method_name} was cancelled"))
                    return
                attempt += 1
                if st.state == pb.ACTOR_ALIVE:
                    # connection died but no death report yet: nudge state
                    reply = await self.control.call(
                        "get_actor_info", {"actor_id": st.actor_id}
                    )
                    if reply["actor"]:
                        self._on_actor_update(reply["actor"])
                if attempt > max_task_retries:
                    self._fail_task(
                        spec,
                        ActorUnavailableError(
                            f"actor task {spec.method_name} failed: {e}"
                        ) if st.state != pb.ACTOR_DEAD else ActorDiedError(
                            f"actor died: {st.death_cause or e}"
                        ),
                    )
                    return
                await asyncio.sleep(min(0.2 * (2 ** attempt), 5.0))

    async def _await_push_turn(self, st: ActorHandleState, spec: TaskSpec):
        """Block until every lower sequence number of this incarnation has
        been pushed (or terminally failed). Retried pushes (seq <= push_next)
        pass straight through. A spec whose incarnation is now STALE (the
        actor restarted while it was parked here) must NOT be pushed — it
        would execute unordered on the fresh executor ahead of its restamped
        predecessors — so it is bounced back to the retry loop for
        restamping."""
        if spec.seq_no < 0:
            return
        while True:
            if spec.incarnation > st.push_incarnation:
                # actor restarted: fresh incarnation numbers from 1
                st.push_incarnation = spec.incarnation
                st.push_next = 1
                self._wake_push_waiters(st, wake_all=True)
            if spec.incarnation < st.push_incarnation:
                raise _ActorRestartedWhileQueued(
                    f"incarnation {spec.incarnation} superseded by "
                    f"{st.push_incarnation}")
            if spec.seq_no <= st.push_next:
                return
            fut = self.loop.create_future()
            st.push_waiters[spec.seq_no] = fut
            try:
                await fut
            finally:
                if st.push_waiters.get(spec.seq_no) is fut:
                    st.push_waiters.pop(spec.seq_no, None)

    def _release_push_turn(self, st: ActorHandleState, spec: TaskSpec):
        """Idempotent: the push went out (or the spec terminally failed) —
        let the next sequence number proceed. Handles an incarnation the
        await path never saw (a spec restamped then failed before pushing):
        dropping such a release would deadlock every later submission."""
        if spec.seq_no < 0:
            return
        if spec.incarnation > st.push_incarnation:
            st.push_incarnation = spec.incarnation
            st.push_next = 1
            self._wake_push_waiters(st, wake_all=True)
        if spec.incarnation != st.push_incarnation:
            return  # stale incarnation: its ordering domain is gone
        if spec.seq_no + 1 > st.push_next:
            st.push_next = spec.seq_no + 1
            self._wake_push_waiters(st)

    @staticmethod
    def _wake_push_waiters(st: ActorHandleState, wake_all: bool = False):
        """Wake exactly the waiters whose turn arrived (keyed by seq — a
        broadcast would cost O(n^2) wakeups over a deep backlog)."""
        if wake_all:
            waiters, st.push_waiters = st.push_waiters, {}
            for fut in waiters.values():
                if not fut.done():
                    fut.set_result(True)
            return
        ready = [s for s in st.push_waiters if s <= st.push_next]
        for s in ready:
            fut = st.push_waiters.pop(s)
            if not fut.done():
                fut.set_result(True)

    async def _actor_push(self, st: ActorHandleState, spec: TaskSpec) -> dict:
        """Coalesced actor-task delivery: enqueue and let one per-actor pump
        ship batches over the connection (reference: pipelined PushTask on
        the actor client). Pushes are RELEASED in sequence order (see
        _await_push_turn); the executor's reorder buffer then only covers
        in-flight wire/dispatch reordering.

        CONCURRENT actors (async/threaded/concurrency groups) bypass the
        pump entirely: their executions overlap on the worker, and a batched
        reply would couple a fast method's completion to the slowest task in
        its batch (head-of-line blocking across concurrency lanes)."""
        if st.concurrent:
            client = st.client
            if client is None:
                raise RpcConnectionLost("actor client not connected")
            return await client.call(
                "push_task", {"spec": spec.to_wire()}, timeout=None)
        await self._await_push_turn(st, spec)
        fut = self.loop.create_future()
        st.push_queue.append((spec, fut))
        self._release_push_turn(st, spec)
        if not st.pump_running:
            st.pump_running = True
            spawn(self._actor_push_pump(st))
        return await fut

    async def _actor_push_pump(self, st: ActorHandleState):
        """Drain the queue into batches and ship them WITHOUT awaiting
        replies between sends. An ordered actor may block one delivered
        batch in its reorder buffer until a lower seq (still queued here)
        arrives — a pump that awaited each reply before sending the next
        batch would deadlock on exactly that. Sorting each drain by
        (incarnation, seq) keeps lower seqs no later than higher ones."""
        try:
            while st.push_queue:
                maxb = GLOBAL_CONFIG.get("push_batch_max")
                drained = [
                    item for item in (
                        st.push_queue.popleft()
                        for _ in range(len(st.push_queue))
                    ) if not item[1].done()
                ]
                drained.sort(key=lambda it: (it[0].incarnation, it[0].seq_no))
                for i in range(0, len(drained), maxb):
                    spawn(self._actor_send_batch(st, drained[i:i + maxb]))
                if not st.push_queue:
                    return
        finally:
            st.pump_running = False
            if st.push_queue:
                # enqueued in the window after the loop saw empty
                st.pump_running = True
                spawn(self._actor_push_pump(st))

    async def _actor_send_batch(self, st: ActorHandleState, batch: list):
        client = st.client
        try:
            if client is None:
                raise RpcConnectionLost("actor client not connected")
            reply = await client.call(
                "push_task_batch",
                {"specs": [s.to_wire() for s, _ in batch]},
                timeout=None,
            )
        except BaseException as e:  # noqa: BLE001 — per-call retry loops decide
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(
                        e if isinstance(e, Exception)
                        else RpcConnectionLost(f"push aborted: {e}"))
            if not isinstance(e, Exception):
                raise
            return
        for (_, fut), r in zip(batch, reply["replies"]):
            if not fut.done():
                fut.set_result(r)

    async def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        await self.control.call(
            "kill_actor", {"actor_id": actor_id, "no_restart": no_restart}
        )

    # Actor-handle GC (reference: actor handles participate in reference
    # counting, python/ray/actor.py — an unnamed, non-detached actor dies when
    # the creator's last handle goes out of scope).
    def add_actor_handle_ref(self, actor_id: bytes):
        with self._lock:
            self._owned_actor_handles[actor_id] = (
                self._owned_actor_handles.get(actor_id, 0) + 1
            )
        self.drain_actor_handle_refs()

    def remove_actor_handle_ref_deferred(self, actor_id: bytes):
        """``ActorHandle.__del__``'s release: like an ObjectRef's
        (ReferenceCounter.release_deferred), it takes no lock — _lock may be
        held by the very thread whose allocation ran the finaliser."""
        self._released_handles.append(actor_id)
        try:
            self.loop.call_soon_threadsafe(self.drain_actor_handle_refs)
        except RuntimeError:  # the loop is closed: shutdown
            pass

    def drain_actor_handle_refs(self):
        while True:
            try:
                actor_id = self._released_handles.popleft()
            except IndexError:
                return
            self.remove_actor_handle_ref(actor_id)

    def remove_actor_handle_ref(self, actor_id: bytes):
        with self._lock:
            n = self._owned_actor_handles.get(actor_id, 0) - 1
            if n > 0:
                self._owned_actor_handles[actor_id] = n
                return
            self._owned_actor_handles.pop(actor_id, None)
        self.schedule(self._kill_on_gc(actor_id))

    async def _kill_on_gc(self, actor_id: bytes):
        try:
            await self.kill_actor(actor_id, no_restart=True)
        except Exception:  # noqa: BLE001 — shutdown race
            pass

    # ------------------------------------------------------------------
    # executor side (workers; reference: core_worker.cc:3672 HandlePushTask)
    # ------------------------------------------------------------------

    async def rpc_push_task(self, conn_id: int, payload: dict) -> dict:
        assert self.executor is not None, "push_task on a non-worker process"
        spec = TaskSpec.from_wire(payload["spec"])
        return await self.executor.execute(spec)

    async def rpc_push_task_batch(self, conn_id: int, payload: dict) -> dict:
        """Pipelined batch delivery (reference: back-to-back PushNormalTask
        on one granted lease): tasks run sequentially — the lease grants one
        worker — and the replies travel in one frame. The reply carries the
        server-side residency (`srv_ns`) so the owner's wire_rtt hop
        excludes execution time without any cross-host clock comparison."""
        assert self.executor is not None, "push_task_batch on a non-worker process"
        traced = hops.enabled()
        t_recv = time.monotonic_ns() if traced else 0
        specs = [TaskSpec.from_wire(w) for w in payload["specs"]]
        if traced:
            recv_wall = time.time()
            for spec in specs:
                spec._recv_ns = t_recv
                spec._recv_wall = recv_wall
        reply = {"replies": await self.executor.execute_batch(specs)}
        if traced:
            reply["srv_ns"] = time.monotonic_ns() - t_recv
        return reply

    async def resolve_arg(self, arg: dict) -> Any:
        if "inline" in arg:
            return ser.deserialize(arg["inline"], copy_buffers=True)
        ref = ObjectRef(
            ObjectID(arg["ref"]), arg["owner"], arg["owner_worker_id"], _register=False
        )
        if self.owns(ref):
            return await self._get_one(ref)
        # check local shm first (zero-copy fast path)
        if self.store is not None and self.store.contains(ref.object_id()):
            res = self.store.get(ref.object_id())
            if res is not None:
                view, meta = res
                if meta == META_ERROR:
                    try:
                        raise self._deserialize_error(bytes(view))
                    finally:
                        self.store.release(ref.object_id())
                return ser.deserialize(
                    view, copy_buffers=False,
                    release=functools.partial(self.store.release, ref.object_id()),
                )
        return await self._fetch_via_owner(ref, None, copy_buffers=True)

    async def _create_with_spill(self, oid: ObjectID, size: int,
                                 meta: int = META_NORMAL) -> memoryview:
        """create() with BACKPRESSURE: a full store asks the daemon to spill
        and then retries with backoff until capacity appears (spilling,
        eviction, or consumers releasing refs) or the grace period expires
        (reference: plasma create_request_queue.h — creates queue under
        memory pressure instead of failing immediately)."""
        try:
            return self.store.create(oid, size, meta)
        except ObjectStoreFullError:
            pass
        deadline = time.monotonic() + GLOBAL_CONFIG.get(
            "object_store_full_timeout_s")
        delay = GLOBAL_CONFIG.get("object_store_full_delay_s")
        last_exc: Optional[Exception] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            # a dead/hung daemon propagates (as before this backpressure
            # existed) rather than masquerading as a full store. The fixed
            # generous timeout lets a SLOW-but-working multi-GB spill finish
            # (overrunning the grace period by at most one call is better
            # than failing a create the spill was about to satisfy).
            await self.daemon.call(
                "spill_now", {"need_bytes": size}, timeout=120)
            try:
                return self.store.create(oid, size, meta)
            except ObjectStoreFullError as e:
                last_exc = e
            await asyncio.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2, 1.0)
        raise ObjectStoreFullError(
            f"object store still full after "
            f"{GLOBAL_CONFIG.get('object_store_full_timeout_s')}s waiting "
            f"for capacity ({size} bytes needed): {last_exc}")

    async def store_return(self, oid: ObjectID, sobj: ser.SerializedObject,
                           meta: int = META_NORMAL) -> dict:
        """Store one return value; small→inline reply, large→local shm."""
        if sobj.total_bytes <= self._inline_max:
            return {"object_id": oid.binary(), "inline": sobj.to_bytes(), "meta": meta}
        try:
            view = await self._create_with_spill(oid, sobj.total_bytes, meta)
            sobj.write_into(view)
            view.release()
            self.store.seal(oid)
        except FileExistsError:
            pass
        return {
            "object_id": oid.binary(),
            "inline": None,
            "location": {"daemon": self.daemon_address, "node_id": self.node_id_hex},
        }
