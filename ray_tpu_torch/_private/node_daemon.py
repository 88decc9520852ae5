"""Node daemon — the per-node agent (raylet equivalent).

Capability parity with the reference's raylet (reference: src/ray/raylet/
node_manager.h:144, worker_pool.h:284, scheduling/cluster_lease_manager.h:41,
scheduling/local_lease_manager.h:62, object_manager/object_manager.h:137):

- owns the node's shared-memory object store (native, ray_tpu_torch/native/shm_store.cc);
- spawns and pools worker processes (keyed by job, cached idle, monitored for
  death — reference: worker_pool.h:284);
- serves worker leases with a two-level scheduler: a cluster policy choosing a
  node from the gossiped resource view (hybrid pack/spread, reference:
  hybrid_scheduling_policy.h:50) with spillback replies, and a local grant path
  that queues until resources free up (reference: cluster_lease_manager.cc:195);
- reserves/commits placement-group bundles 2-phase (reference:
  node_manager.proto:515-525, placement_group_resource_manager.h);
- transfers objects node-to-node in chunks pulled into the local store
  (reference: object_manager/pull_manager.h:52, push_manager.h:28).
"""

from __future__ import annotations

import asyncio
from ray_tpu_torch._private.aio import spawn
import json
import logging
import os
import signal
import subprocess
import sys
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private import protocol as pb
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.errors import ObjectStoreFullError
from ray_tpu_torch._private.ids import NodeID, ObjectID, WorkerID
from ray_tpu_torch._private.protocol import NodeInfo, ResourceSet, TaskSpec
from ray_tpu_torch.runtime.object_store import ShmObjectStore
from ray_tpu_torch.runtime.rpc import RpcClient, RpcServer

logger = logging.getLogger(__name__)


def _read_file_range(path: str, offset: int, limit: int) -> bytes:
    """Bounded positional read, run in a worker thread by the async log/
    profile paths so the daemon's event loop never blocks on disk."""
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(limit)


W_STARTING = "STARTING"
W_IDLE = "IDLE"
W_LEASED = "LEASED"
W_ACTOR = "ACTOR"
W_DEAD = "DEAD"


class WorkerHandle:
    __slots__ = (
        "worker_id", "proc", "state", "address", "pid", "job_id",
        "client", "lease_id", "actor_id", "ready_event", "idle_since",
        "actor_resources", "actor_pg", "gpu_devices", "reserved", "env_key",
        "spawn_ts", "drain_coop",
    )

    def __init__(self, worker_id: WorkerID, proc: subprocess.Popen, job_id: bytes):
        self.worker_id = worker_id
        self.proc = proc
        self.state = W_STARTING
        self.address = ""
        self.pid = proc.pid
        self.job_id = job_id
        self.spawn_ts = time.monotonic()  # OOM policy kills newest first
        # runtime-env isolation key this worker was spawned for ("" = plain
        # pooled worker; reference: worker_pool.h keys by runtime_env_hash)
        self.env_key = ""
        self.client: Optional[RpcClient] = None
        self.lease_id: Optional[bytes] = None
        self.actor_id: Optional[bytes] = None
        self.ready_event = asyncio.Event()
        self.idle_since = time.monotonic()
        self.actor_resources: Optional[ResourceSet] = None
        # (pg_id, bundle_index) when the actor consumes a PG bundle
        self.actor_pg: Optional[Tuple[bytes, int]] = None
        # actor whose owner coordinates planned removal (elastic gangs):
        # a terminal drain holds the node open while it lives
        self.drain_coop = False
        # device ids this worker's CUDA_VISIBLE_DEVICES was baked with at
        # spawn (visibility is per-process: it cannot change after CUDA init)
        self.gpu_devices: Optional[Tuple[int, ...]] = None
        # spawned for a specific waiting grantee: worker_ready must NOT
        # publish it to the idle pool (a concurrent _get_idle_worker could
        # lease it out from under the spawner)
        self.reserved = False


class PendingLease:
    __slots__ = ("spec_resources", "strategy", "job_id", "future", "hops",
                 "runtime_env", "t0_ns")

    def __init__(self, spec_resources: ResourceSet, strategy: pb.SchedulingStrategy,
                 job_id: bytes, hops: int,
                 runtime_env: Optional[dict] = None):
        self.spec_resources = spec_resources
        self.strategy = strategy
        self.job_id = job_id
        self.future: asyncio.Future = asyncio.get_running_loop().create_future()
        self.hops = hops
        # request-arrival stamp: the grant reply carries queue-to-grant time
        # (the per-hop decomposition's `grant` hop, daemon-side truth)
        self.t0_ns = time.monotonic_ns()
        # wire runtime env when it needs a dedicated worker (pip venv,
        # working_dir); None for plain leases
        self.runtime_env = runtime_env


class NodeDaemon:
    def __init__(
        self,
        control_address: str,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        session_dir: str = "/tmp/ray_tpu_sessions",
        host: str = "127.0.0.1",
        store_name: Optional[str] = None,
    ):
        self.node_id = NodeID.from_random()
        self.control_address = control_address
        self.host = host
        self.session_dir = session_dir
        os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
        # cgroup-v2 isolation (opt-in; reference: cgroup_manager.h) — the
        # daemon itself is a "system" process, workers are confined
        from ray_tpu_torch._private.cgroup import manager_from_config

        self.cgroups = manager_from_config(os.path.basename(session_dir))
        if self.cgroups is not None and self.cgroups.setup(
                system_pids=[os.getpid()]):
            logger.info("cgroup2 worker isolation active under %s",
                        self.cgroups.base)
        else:
            self.cgroups = None
        res = dict(resources or {})
        if "CPU" not in res:
            res["CPU"] = float(os.cpu_count() or 1)
        self.labels = dict(labels or {})
        # spot/preemptible marker normalization: a node advertising the
        # "spot" custom resource IS spot capacity — mirror it into the
        # label plane so anti-affinity selectors (label_selector=
        # {"spot": "!true"}) can keep coordination actors off it
        if res.get("spot"):
            self.labels.setdefault("spot", "true")
        gpu_ids = None
        # CUDA_VISIBLE_DEVICES of every worker when the gpu_visible_devices
        # flag narrowed the node's devices (None: workers inherit the env)
        self._node_visible_gpus: Optional[str] = None
        if "GPU" not in res and os.environ.get("RT_GPU_AUTODETECT"):
            # detection without a CUDA context or torch: the daemon must not
            # hold a context on the devices its workers use. Opt-in: on
            # shared hosts several fake daemons coexist with real devices.
            from ray_tpu_torch.gpu.accelerator import GpuAcceleratorManager

            info = GpuAcceleratorManager.detect(allow_cuda_probe=False)
            if info is not None:
                gpu_res, gpu_labels = (
                    GpuAcceleratorManager.node_resources_and_labels(info)
                )
                res.update(gpu_res)
                self.labels.update(gpu_labels)
                gpu_ids = list(info.device_ids)
                if GLOBAL_CONFIG.get("gpu_visible_devices"):
                    self._node_visible_gpus = ",".join(map(str, gpu_ids))
        self.total_resources = ResourceSet(res)
        self.available = ResourceSet(res)
        # Free CUDA device ids (the TPU chips' visibility semantics: each
        # granted lease/actor with {"GPU": n} takes n specific devices and
        # the worker is spawned with CUDA_VISIBLE_DEVICES restricted to
        # them). Detected devices keep their physical ids.
        self._gpu_free: List[int] = (
            gpu_ids if gpu_ids is not None
            else list(range(int(res.get("GPU", 0)))))
        self._gpus_per_host = len(self._gpu_free)
        self.store_name = store_name or f"rt_{self.node_id.hex()[:12]}"
        self.store: Optional[ShmObjectStore] = None
        self.server = RpcServer(name=f"daemon-{self.node_id.hex()[:6]}")
        self.control: Optional[RpcClient] = None
        # worker pool
        self.workers: Dict[bytes, WorkerHandle] = {}
        # idle pool keyed by (job_id, env_key) — workers built for a
        # pip/working_dir env serve only that env (worker_pool.h hash)
        self.idle_by_job: Dict[Tuple[bytes, str], List[bytes]] = {}
        # leases
        self.leases: Dict[bytes, Tuple[bytes, ResourceSet, Optional[bytes]]] = {}
        #   lease_id -> (worker_id, resources, pg_id, bundle_index)
        self.pending: List[PendingLease] = []
        # recently-rejected infeasible lease shapes (deduped): reported in
        # heartbeats so the autoscaler can provision nodes for demand no
        # current node can host (clients retry infeasible leases every
        # ~0.5s, refreshing these entries until capacity appears)
        self._infeasible_seen: Dict[tuple, float] = {}
        # idempotency for retried RPCs (dropped/timed-out calls re-sent by
        # clients must not double-grant/double-create)
        self._lease_requests: Dict[bytes, asyncio.Task] = {}
        self._lease_key_by_id: Dict[bytes, bytes] = {}
        # request_keys cancelled before their request_lease arrived (the
        # dead connection's frame or a resend can land after the cancel):
        # a tombstoned key is refused instead of queued-and-leaked
        self._cancelled_lease_keys: "OrderedDict[bytes, float]" = OrderedDict()
        self._creating_actors: Dict[bytes, asyncio.Task] = {}
        # cluster view: node_id hex -> available ResourceSet
        self.cluster_view: Dict[str, ResourceSet] = {}
        # per-origin gossip versions (reference: ray_syncer versioned
        # snapshots); my own availability publishes under _my_view_seq
        self._view_seq: Dict[str, int] = {}
        self._my_view_seq = 0
        self.peer_nodes: Dict[str, NodeInfo] = {}
        self._peer_clients: Dict[str, RpcClient] = {}
        # placement groups: pg_id -> {"bundles": {idx: ResourceSet}, "state", "free": {idx: ResourceSet}}
        self.pg_prepared: Dict[bytes, dict] = {}
        self._tasks: List[asyncio.Task] = []
        self._stopped = False
        self._draining = False
        # monotonic stamp of the last authoritative drain-state sync; an
        # in-flight heartbeat reply issued BEFORE a pubsub drain update must
        # not roll the state back (reply snapshots are unordered vs pubsub)
        self._drain_sync_ts = 0.0
        # terminal-drain orchestration (one per daemon lifetime): set when a
        # deadline-carrying drain notice lands; run_daemon wires _exit_cb so
        # the process exits cleanly once the drain completes
        self._drain_task: Optional[asyncio.Task] = None
        self._exit_cb = None
        # preemption watcher (real metadata polling or the chaos stand-in);
        # kept for introspection/stop and so tests can assert publish counts
        self._preempt_watcher = None
        # subscriber-side pubsub gap detection: last publish seq seen on the
        # "nodes" channel (control_store stamps every notice with _seq)
        self._nodes_seq: Optional[int] = None
        # node-table version cursor (scale plane): the max `_v` applied from
        # notices/deltas — reconciles pull get_nodes_delta(cursor) instead
        # of the full table, and an IN-STREAM seq jump (bounded-backlog shed
        # at the store) triggers the same cheap reconcile
        self._node_table_version = -1
        self._view_cursor = -1  # availability-view version (heartbeat delta)
        self._nodes_reconcile_task: Optional[asyncio.Task] = None
        # pre-gap cursor pinned at gap-detection time (the reconcile task
        # runs deferred; by then the gap-revealing notice's _v has advanced
        # the cursor past the shed window and a pull would replay nothing);
        # also re-armed by gaps landing while a reconcile is in flight
        self._nodes_reconcile_from: Optional[int] = None
        self._pulls_inflight: Dict[bytes, asyncio.Future] = {}
        # per-node metric pre-aggregation (reference: the per-node metrics
        # agent): workers ship DELTAS here; this daemon merges them into one
        # per-node series set under a cardinality cap and forwards the
        # merged deltas to the control store on the telemetry cadence
        self._metrics_pending: Dict[tuple, dict] = {}
        self._metrics_keys: Set[tuple] = set()
        self._metrics_dropped = 0
        # (reporter -> last applied seq): report_metrics is retried
        # verbatim by workers until acked, so ingestion dedups by sequence
        # — an applied-but-unacked flush must not double-count
        self._metrics_last_seq: "OrderedDict[bytes, int]" = OrderedDict()
        # daemon addresses declared dead by the control store: pulls from
        # them fail fast instead of retrying into a void (authoritative
        # death beats connect timeouts)
        self._dead_peer_addrs: Set[str] = set()
        # in-progress remote-client puts: oid -> (writable view, last-touch
        # ts). Swept by the reap loop — a client dying mid-put must not pin
        # store capacity forever (unsealed entries are not evictable).
        self._inbound_creates: Dict[bytes, Tuple[memoryview, float]] = {}
        # spilled objects: oid bytes -> (path, metadata, size). Reference:
        # raylet local_object_manager.h:45 spill/restore of primary copies.
        self.spilled: Dict[bytes, Tuple[str, int, int]] = {}
        self.spill_dir = os.path.join(
            session_dir, "spill", self.node_id.hex()[:12]
        )
        self._spill_lock: Optional[asyncio.Lock] = None
        # spawn-ordered suffix for worker chaos roles (deterministic fault
        # schedules — see _private.chaos)
        self._worker_role_counter = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self, port: int = 0) -> str:
        self.store = ShmObjectStore(
            self.store_name,
            create=True,
            size=GLOBAL_CONFIG.get("object_store_memory_bytes"),
        )
        self.server.register_service(self)
        addr = await self.server.start(self.host, port)
        self.address = addr
        self.control = RpcClient(self.control_address, name="daemon->cs")
        await self.control.connect()
        info = NodeInfo(
            node_id=self.node_id,
            address=addr,
            object_store_name=self.store_name,
            resources=self.total_resources,
            labels=self.labels,
        )
        self._node_info = info
        # Event-driven peer discovery: node registrations/deaths push over
        # the "nodes" channel, so the scheduler's cluster view is populated
        # at member-change time instead of waiting for heartbeat gossip
        # (reference: GcsNodeManager node add/removed pubsub).
        self.control.subscribe_channel("nodes", self._on_node_update)
        await self._subscribe_nodes()
        self.control.on_reconnect(
            lambda: self._subscribe_nodes(resync=True)
        )
        reg = await self.control.call("register_node", {"node": info.to_wire()})
        if reg.get("version") is not None:
            # the seed reply reflects the table at this version: start the
            # delta cursor here so the first reconcile is incremental
            self._node_table_version = reg["version"]
        for nw in reg.get("nodes", []):
            self._on_node_update(nw)
        self._tasks.append(spawn(self._heartbeat_loop()))
        self._tasks.append(spawn(self._reap_loop()))
        self._tasks.append(spawn(self._metrics_ship_loop()))
        if GLOBAL_CONFIG.get("log_to_driver"):
            self._tasks.append(spawn(self._log_forward_loop()))
        if GLOBAL_CONFIG.get("object_spill_enabled"):
            os.makedirs(self.spill_dir, exist_ok=True)
            self._tasks.append(spawn(self._spill_loop()))
        prestart = GLOBAL_CONFIG.get("worker_pool_prestart")
        if prestart < 0:
            prestart = min(
                16, int(self.total_resources.to_dict().get("CPU", 0)))
        for _ in range(prestart):
            spawn(self._spawn_worker(job_id=b"", reserve=False))
        self._oom_kills = 0
        self._tasks.append(spawn(self._memory_monitor_loop()))
        self._tasks.append(spawn(self._resource_gossip_loop()))
        # preemption plane: a real (GCE maintenance-event metadata/SIGTERM)
        # or synthetic (seeded chaos) preemption notice triggers a terminal
        # drain — the 30-90s of warning spot GPU VMs give must not be
        # thrown away (reference: autoscaler preemption handling)
        notice = chaos.preempt_notice()
        if notice is not None:
            delay_s, deadline_s = notice
            self._tasks.append(spawn(self._chaos_preempt(delay_s, deadline_s)))
        # correlated spot-reclaim wave (testing_preempt_wave): a seeded draw
        # preempts a fraction of the SPOT fleet inside one window — only
        # nodes advertising spot/preemptible capacity are eligible victims
        wave = chaos.preempt_wave(
            self.labels.get("spot") == "true"
            or self.labels.get("preemptible") == "true")
        if wave is not None:
            offset_s, deadline_s = wave
            self._tasks.append(spawn(self._chaos_preempt(offset_s, deadline_s)))
        if GLOBAL_CONFIG.get("preemption_watcher_enabled"):
            self._preempt_watcher = self._make_preempt_watcher()
            self._tasks.append(spawn(self._preempt_watcher.run()))
        logger.info(
            "daemon %s up at %s store=%s resources=%s",
            self.node_id.hex()[:8], addr, self.store_name, self.total_resources.to_dict(),
        )
        return addr

    async def stop(self):
        self._stopped = True
        if self._preempt_watcher is not None:
            self._preempt_watcher.stop()
        for t in self._tasks:
            t.cancel()
        for w in list(self.workers.values()):
            self._kill_worker_proc(w, "daemon shutdown")
        if self.control:
            await self.control.close()
        for c in self._peer_clients.values():
            await c.close()
        await self.server.stop()
        if self.store:
            self.store.destroy()
        if self.cgroups is not None:
            self.cgroups.cleanup()

    def _sync_drain_state(self, info: NodeInfo):
        """Mirror the control store's view of this node into the local
        lease gate (reference: DrainRaylet; undrain re-opens local grants).
        A drain carrying a deadline is TERMINAL (preemption / planned
        removal): beyond gating leases, it starts the full orchestration —
        finish running work, replicate primary copies, exit with an
        expected-termination record."""
        self._drain_sync_ts = time.monotonic()
        draining = info.state == pb.NODE_DRAINING
        if self._drain_task is not None and not draining:
            # terminal drain is one-way: once the exit orchestration is in
            # flight (e.g. a local preemption notice the store never heard
            # about), an ALIVE snapshot must not reopen the lease gate on a
            # node that is about to die — new tasks would be routed onto it
            # only to be killed at the deadline
            return
        if draining != self._draining:
            self._draining = draining
            logger.info("node %s drain -> %s (%s)", self.node_id.hex()[:8],
                        draining, info.drain_reason or "-")
            if not draining:
                self._try_schedule()
        if draining and info.drain_deadline and self._drain_task is None:
            # wall-clock deadline from the control store -> local monotonic
            deadline = time.monotonic() + max(
                0.0, info.drain_deadline - time.time())
            self._drain_task = spawn(
                self._drain_and_exit(info.drain_reason, deadline))

    async def _subscribe_nodes(self, resync: bool = False):
        """Subscribe to the "nodes" channel, detecting publish gaps: the
        subscribe reply carries the channel's current seq — a reconnect
        whose reply seq doesn't match the last notice we saw means deaths/
        drains were published while we were away (control-store failover
        window), so reconcile against the full node table instead of
        trusting the stream."""
        # capture the cursor BEFORE the subscribe lands: once the new
        # subscription exists, stream notices can max-advance the cursor
        # past the missed window and blind both the version comparison
        # and the reconcile's from-cursor pull
        pre_cursor = self._node_table_version
        reply = await self.control.call("subscribe", {"channel": "nodes"})
        server_seq = reply.get("seq")
        last_seen = self._nodes_seq
        # seq mismatch OR version-cursor mismatch: the ephemeral seq alone
        # can COINCIDE across a failover (new incumbent published exactly
        # as many notices as we had seen); the persisted version cursor
        # breaks the tie
        gap = resync and (
            (server_seq is not None and server_seq != last_seen)
            or (reply.get("version") is not None
                and reply["version"] != pre_cursor))
        if gap and (self._nodes_reconcile_from is None
                    or pre_cursor < self._nodes_reconcile_from):
            self._nodes_reconcile_from = pre_cursor
        if resync:
            # failover telemetry: outage as this daemon saw it + whether
            # the reconnect landed on a new store incarnation
            from ray_tpu_torch._private import store_ha

            outage = None
            if self.control.last_disconnect_ts is not None:
                outage = time.monotonic() - self.control.last_disconnect_ts
            store_ha.record_store_reconnect("daemon", outage,
                                            new_incarnation=gap)
        if gap:
            logger.info("nodes-channel gap detected (last seen %s, server "
                        "at %s); reconciling node table", last_seen, server_seq)
            if not await self._reconcile_nodes():
                # keep the old last-seen seq so the next reconnect
                # re-detects this gap instead of marking it seen
                return
        if server_seq is not None:
            # RESET the baseline to the server's seq (don't max): a store
            # restart resets its counters, and a sticky high-water mark
            # would re-detect a phantom gap — and re-run the full table
            # reconcile — on every reconnect until the new counter caught up
            self._nodes_seq = server_seq

    def _spawn_nodes_reconcile(self) -> None:
        """One reconcile in flight at a time — a burst of gap signals
        (every shed notice of a churn wave) coalesces into one pull."""
        if (self._nodes_reconcile_task is None
                or self._nodes_reconcile_task.done()):
            self._nodes_reconcile_task = spawn(self._reconcile_nodes())

    async def _reconcile_nodes(self) -> bool:
        """Replay node-table mutations missed on the pubsub stream. With
        delta sync on this pulls get_nodes_delta(cursor) — O(missed
        changes); the wires are the exact notices the stream would have
        delivered (same `_v`/replica payloads), applied through the same
        handler. Falls back to the full table otherwise. Loops while
        fresh gap signals land mid-flight — a reply generated before a
        second shed cannot contain it."""
        while True:
            floor = self._nodes_reconcile_from
            self._nodes_reconcile_from = None
            pre = self._node_table_version
            try:
                full = True
                if GLOBAL_CONFIG.get("node_table_delta_sync"):
                    reply = await self.control.call(
                        "get_nodes_delta",
                        {"cursor": floor if floor is not None else pre})
                    full = bool(reply.get("full"))
                    nodes = reply.get("updates") or reply.get("nodes") or []
                    version = reply.get("version")
                else:
                    version = None
                    nodes = (await self.control.call(
                        "get_all_nodes", {})).get("nodes", [])
                for nw in nodes:
                    self._apply_node_update(nw)
                if full:
                    # a full snapshot is authoritative membership: peers
                    # absent from it (dead + already pruned from the
                    # store's retention window) must not linger in the
                    # scheduling view
                    present = {NodeInfo.from_wire(nw).node_id.hex()
                               for nw in nodes}
                    for hexid in list(self.peer_nodes):
                        if hexid not in present:
                            self.peer_nodes.pop(hexid, None)
                            self.cluster_view.pop(hexid, None)
                            self._view_seq.pop(hexid, None)
                if version is not None:
                    # authoritative assignment AFTER the apply: brings the
                    # cursor back DOWN after a store restart's counter
                    # reset (the stream path's monotonic guard never would)
                    self._node_table_version = version
            except Exception:  # noqa: BLE001 — store still mid-failover:
                # re-arm the pre-gap floor (stream notices advance the
                # live cursor past the missed window; a later from-cursor
                # pull would replay nothing) for the next gap signal /
                # reconnect / heartbeat-version retry
                used = floor if floor is not None else pre
                if (self._nodes_reconcile_from is None
                        or used < self._nodes_reconcile_from):
                    self._nodes_reconcile_from = used
                logger.warning("node-table reconcile failed", exc_info=True)
                return False
            if self._nodes_reconcile_from is None:
                return True

    def _on_node_update(self, message: dict):
        seq = message.get("_seq")
        if seq is not None:
            if self._nodes_seq is not None and seq > self._nodes_seq + 1:
                # in-stream publish gap: the store shed notices to us (its
                # bounded per-subscriber backlog) — reconcile from the
                # PRE-gap cursor, pinned NOW: this very message's _v will
                # advance the cursor past the shed window before the
                # deferred reconcile task runs
                logger.info("nodes-channel in-stream gap (%d -> %d); "
                            "reconciling", self._nodes_seq, seq)
                if (self._nodes_reconcile_from is None
                        or self._node_table_version
                        < self._nodes_reconcile_from):
                    self._nodes_reconcile_from = self._node_table_version
                self._spawn_nodes_reconcile()
            self._nodes_seq = max(self._nodes_seq or 0, seq)
        ver = message.get("_v")
        if ver is not None:
            if ver <= self._node_table_version:
                # stale replay: the store's coalescing window can deliver
                # a notice AFTER the reconcile reply that already covered
                # it — applying would resurrect superseded state (e.g. a
                # DEAD peer back to DRAINING). A restarted store's lower
                # counter is reset by _reconcile_nodes' authoritative
                # post-apply assignment, so skipping here can't wedge.
                return
            self._node_table_version = ver
        self._apply_node_update(message)

    def _apply_node_update(self, message: dict):
        info = NodeInfo.from_wire(message)
        hexid = info.node_id.hex()
        if hexid == self.node_id.hex():
            self._sync_drain_state(info)
            return
        if info.state == pb.NODE_ALIVE:
            self.peer_nodes[hexid] = info
            # an address can be reused by a re-registered node: it is no
            # longer an authoritatively-dead pull source
            self._dead_peer_addrs.discard(info.address)
            # seed with total resources; the next gossip beat corrects it
            self.cluster_view.setdefault(hexid, info.resources)
            self._try_schedule()
        else:
            self.peer_nodes.pop(hexid, None)
            self.cluster_view.pop(hexid, None)
            self._view_seq.pop(hexid, None)
            if info.state == pb.NODE_DEAD:
                # DEAD only — a DRAINING node still serves its objects.
                # Retire the pooled transfer client too: a later pull aimed
                # at the dead peer must fail fast, not burn retries through
                # a half-open cached transport
                self._dead_peer_addrs.add(info.address)
                dead = self._peer_clients.pop(info.address, None)
                if dead is not None:
                    spawn(dead.close())

    # ------------------------------------------------------------------
    # peer resource-view gossip (reference: src/ray/ray_syncer/
    # ray_syncer.h:91 — versioned resource-view snapshots exchanged
    # directly between raylets, decoupling scheduling freshness from the
    # control store's heartbeat cadence and surviving its brief outages)
    # ------------------------------------------------------------------

    def _gossip_entries(self) -> dict:
        """Everything this node knows, keyed by origin: own availability at
        its own (monotonic) version, plus relayed peer entries."""
        self._my_view_seq += 1
        entries = {
            self.node_id.hex(): [self._my_view_seq, self.available.to_wire()]
        }
        for hexid, avail in self.cluster_view.items():
            if hexid == self.node_id.hex():
                continue
            seq = self._view_seq.get(hexid)
            if seq is not None:
                entries[hexid] = [seq, avail.to_wire()]
        return entries

    def _merge_gossip(self, entries: dict) -> bool:
        """Adopt entries with a newer per-origin version; returns whether
        anything changed (→ re-run the scheduler)."""
        changed = False
        for hexid, (seq, wire) in entries.items():
            if hexid == self.node_id.hex():
                continue
            if hexid not in self.peer_nodes:
                continue  # unknown/dead origin: membership comes via pubsub
            if seq > self._view_seq.get(hexid, -1):
                self._view_seq[hexid] = seq
                self.cluster_view[hexid] = ResourceSet.from_wire(wire)
                changed = True
        return changed

    async def rpc_get_view(self, conn_id: int, payload: dict) -> dict:
        """This daemon's current cluster resource view + gossip versions
        (observability/debugging; reference: ray_syncer state dumps)."""
        return {
            "self": self.node_id.hex(),
            "available": self.available.to_wire(),
            "view": {h: a.to_wire() for h, a in self.cluster_view.items()},
            "versions": dict(self._view_seq),
        }

    async def rpc_sync_view(self, conn_id: int, payload: dict) -> dict:
        """Anti-entropy exchange: merge the sender's entries, reply with
        ours (reference: RaySyncer bidi snapshot exchange)."""
        if self._merge_gossip(payload.get("entries", {})):
            self._try_schedule()
        return {"entries": self._gossip_entries()}

    async def _resource_gossip_loop(self):
        period = GLOBAL_CONFIG.get("resource_gossip_period_s")
        if period <= 0:
            return
        import random as _random

        while not self._stopped:
            await asyncio.sleep(period)
            peers = [
                info for hexid, info in self.peer_nodes.items()
                if info.state == pb.NODE_ALIVE
                and hexid != self.node_id.hex()
            ]
            if not peers:
                continue
            fanout = min(len(peers),
                         GLOBAL_CONFIG.get("resource_gossip_fanout"))
            for info in _random.sample(peers, fanout):
                try:
                    client = self._peer_clients.get(info.address)
                    if client is None:
                        client = RpcClient(info.address, name="daemon->peer")
                        await client.connect()
                        self._peer_clients[info.address] = client
                    reply = await client.call(
                        "sync_view", {"entries": self._gossip_entries()},
                        timeout=period * 4)
                    if self._merge_gossip(reply.get("entries", {})):
                        self._try_schedule()
                except Exception:  # noqa: BLE001 — peer down; heartbeat prunes
                    continue

    async def _heartbeat_loop(self):
        import random as _random

        period = (GLOBAL_CONFIG.get("heartbeat_period_s")
                  or GLOBAL_CONFIG.get("health_check_period_s"))
        jitter = GLOBAL_CONFIG.get("heartbeat_jitter")
        delta_sync = GLOBAL_CONFIG.get("node_table_delta_sync")
        # demand-shape budget per beat: leases get the full cap, infeasible
        # shapes a quarter (they only need to be sampled, not enumerated,
        # for the autoscaler to see the node type that's missing)
        shape_cap = GLOBAL_CONFIG.get("heartbeat_pending_shapes_max")
        while not self._stopped:
            try:
                pending_leases = [
                    p for p in self.pending if not p.future.done()
                ]
                now = time.monotonic()
                self._infeasible_seen = {
                    k: t for k, t in self._infeasible_seen.items()
                    if now - t < 5.0
                }
                beat_started = time.monotonic()
                payload = {
                    "node_id": self.node_id.binary(),
                    "available": self.available.to_wire(),
                    # per-node physical stats for the dashboard/state API
                    # (reference: the per-node dashboard agent's psutil
                    # reporter, dashboard/modules/reporter/)
                    "stats": self._node_stats(),
                    # scheduling load → autoscaler demand (reference:
                    # raylet resource-view sync carries load). Infeasible
                    # shapes count too: no live node can host them, but
                    # the autoscaler may be able to provision one.
                    "pending": len(pending_leases) + len(self._infeasible_seen),
                    "pending_resources": [
                        p.spec_resources.to_wire()
                        for p in pending_leases[:shape_cap]
                    ] + [dict(k) for k in
                         list(self._infeasible_seen)[:max(1, shape_cap // 4)]],
                }
                if delta_sync:
                    # scale mode: present the availability cursor — the
                    # reply carries only CHANGES, not the O(nodes) view
                    payload["view_cursor"] = self._view_cursor
                reply = await self.control.call(
                    "heartbeat", payload,
                    # short deadline: a dropped beat must not silence this
                    # node long enough to trip health_check_timeout_s
                    timeout=period * 2,
                )
                if reply.get("unknown"):
                    # the control store restarted without (or before) our
                    # record: re-register so the cluster view includes us
                    await self.control.call(
                        "register_node", {"node": self._node_info.to_wire()}
                    )
                    continue
                if "view_version" in reply:
                    self._apply_view_reply(reply)
                else:
                    self.cluster_view = {
                        nid: ResourceSet.from_wire(w)
                        for nid, w in reply.get("view", {}).items()
                    }
                for nw in reply.get("nodes", []):
                    info = NodeInfo.from_wire(nw)
                    self.peer_nodes[info.node_id.hex()] = info
                    if (info.node_id.hex() == self.node_id.hex()
                            and beat_started > self._drain_sync_ts):
                        # stale-reply guard: a reply snapshotted before the
                        # last pubsub drain/undrain push must not revert it
                        self._sync_drain_state(info)
                self._try_schedule()
            except Exception as e:  # noqa: BLE001
                logger.warning("heartbeat failed: %s", e)
            # jittered sleep: a register storm phase-aligns every daemon's
            # beat; de-phasing keeps 1000 heartbeats from landing on the
            # same control-store event-loop tick
            await asyncio.sleep(
                period * (1.0 + jitter * _random.uniform(-1.0, 1.0)))

    def _apply_view_reply(self, reply: dict) -> None:
        """Fold a cursor heartbeat reply into the scheduling view: changed
        availabilities replace, removed nodes drop, a full snapshot (cursor
        behind the store's change log) rebuilds."""
        full = reply.get("view_full")
        if full is not None:
            self.cluster_view = {
                nid: ResourceSet.from_wire(w) for nid, w in full.items()
            }
        else:
            for nid, w in (reply.get("view_delta") or {}).items():
                self.cluster_view[nid] = ResourceSet.from_wire(w)
            for nid in reply.get("view_removed") or ():
                self.cluster_view.pop(nid, None)
        self._view_cursor = reply["view_version"]
        nodes_version = reply.get("nodes_version")
        if (nodes_version is not None
                and nodes_version != self._node_table_version) \
                or self._nodes_reconcile_from is not None:
            # membership moved while our pubsub stream was quiet (or shed,
            # or the store restarted and reset its counter), OR a pinned
            # pre-gap floor is waiting for a retry (its reconcile failed
            # mid-failover; the live cursor may have caught the server
            # version since, so the version check alone would go blind):
            # pull the missed mutations from the cursor/floor
            self._spawn_nodes_reconcile()

    async def _reap_loop(self):
        """Poll worker processes for death; reap idle surplus."""
        while not self._stopped:
            await asyncio.sleep(0.1)
            self._sweep_stale_inbound_creates()
            for w in list(self.workers.values()):
                if w.state != W_DEAD and w.proc.poll() is not None:
                    await self._on_worker_death(w)
            # reap surplus idle workers (only genuinely idle ones — the list
            # may hold stale ids for workers that have since been leased)
            max_idle = GLOBAL_CONFIG.get("worker_pool_max_idle")
            for job_id, idle in self.idle_by_job.items():
                idle[:] = [
                    wid for wid in idle
                    if self.workers.get(wid) is not None
                    and self.workers[wid].state == W_IDLE
                ]
                while len(idle) > max_idle:
                    wid = idle.pop(0)
                    w = self.workers.get(wid)
                    if w is not None and w.state == W_IDLE:
                        self._kill_worker_proc(w, "idle reaping")

    async def _log_forward_loop(self):
        """Tail workers' stdout/stderr files and push fresh lines to the
        control store's per-job log channel (reference: log_monitor.py
        tailing + GCS pubsub; drivers print them via print_worker_logs)."""
        offsets: Dict[Tuple[bytes, str], int] = {}
        while not self._stopped:
            await asyncio.sleep(0.5)
            for w in list(self.workers.values()):
                short = w.worker_id.hex()[:12]
                for suffix in (".out", ".err"):
                    path = os.path.join(
                        self.session_dir, "logs", f"worker-{short}{suffix}")
                    key = (w.worker_id.binary(), suffix)
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        continue
                    off = offsets.get(key, 0)
                    if size <= off:
                        continue
                    try:
                        # off-loop: one tail read per worker per tick adds up
                        # on a busy node, and log files can sit on slow disks
                        chunk = await asyncio.to_thread(
                            _read_file_range, path, off,
                            min(size - off, 256 * 1024))
                    except OSError:
                        continue
                    offsets[key] = off + len(chunk)
                    lines = chunk.decode("utf-8", "replace").splitlines()
                    if not lines:
                        continue
                    try:
                        await self.control.call("publish_logs", {
                            "job_id": w.job_id,
                            "worker_id": w.worker_id.binary(),
                            "node_id": self.node_id.hex(),
                            "stream": suffix[1:],
                            "lines": lines[:200],
                        }, timeout=5)
                    except Exception:  # noqa: BLE001 — control blip; retry next tick
                        offsets[key] = off  # re-read the chunk next round
            # drop offsets of forgotten workers
            live = {w.worker_id.binary() for w in self.workers.values()}
            for key in [k for k in offsets if k[0] not in live]:
                offsets.pop(key, None)

    # ------------------------------------------------------------------
    # worker pool (reference: worker_pool.h:284)
    # ------------------------------------------------------------------

    async def _spawn_worker(self, job_id: bytes,
                            gpu_devices: Optional[List[int]] = None,
                            reserve: bool = True,
                            env_key: str = "",
                            runtime_env: Optional[dict] = None) -> WorkerHandle:
        worker_id = WorkerID.from_random()
        log_base = os.path.join(
            self.session_dir, "logs", f"worker-{worker_id.hex()[:12]}"
        )
        env = dict(os.environ)
        env.update(
            RT_CONTROL_ADDR=self.control_address,
            RT_DAEMON_ADDR=self.address,
            RT_NODE_ID=self.node_id.hex(),
            RT_WORKER_ID=worker_id.hex(),
            RT_STORE_NAME=self.store_name,
            RT_JOB_ID=job_id.hex(),
            RT_SESSION_DIR=self.session_dir,
            RT_CONFIG_JSON=GLOBAL_CONFIG.serialize_overrides(),
            RT_ENV_KEY=env_key,
            # spawn-ordered chaos role (see _private.chaos: the seeded PRNG
            # mixes in this label, making worker fault schedules replayable)
            RT_CHAOS_ROLE=f"{chaos.role()}.w{self._worker_role_counter}",
        )
        self._worker_role_counter += 1
        # the framework itself must resolve from the env worker's (possibly
        # venv) interpreter regardless of cwd
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        python_exe = sys.executable
        cwd = None
        if env_key and runtime_env:
            python_exe, cwd = await self._build_worker_env(runtime_env)
        if self._node_visible_gpus is not None:
            env["CUDA_VISIBLE_DEVICES"] = self._node_visible_gpus
        if gpu_devices:
            from ray_tpu_torch.gpu.accelerator import GpuAcceleratorManager

            GpuAcceleratorManager.set_visible_devices_env(
                env, list(gpu_devices), self._gpus_per_host
            )
        try:
            # rtlint: disable=R001 paired with the Popen below: worker spawn is a ms-scale cold path, not per-task
            out = open(log_base + ".out", "ab")
            err = open(log_base + ".err", "ab")  # rtlint: disable=R001 see line above
            proc = subprocess.Popen(
                [python_exe, "-m", "ray_tpu_torch._private.default_worker"],
                env=env, stdout=out, stderr=err, start_new_session=True,
                cwd=cwd,
            )
            out.close()
            err.close()
        except Exception:
            if gpu_devices:
                self._return_gpus(gpu_devices)
            raise
        if self.cgroups is not None:
            self.cgroups.add_worker(proc.pid)
        handle = WorkerHandle(worker_id, proc, job_id)
        handle.env_key = env_key
        handle.reserved = reserve
        if gpu_devices:
            # from here on the devices travel with the handle; _forget_worker
            # returns them to the pool exactly once
            handle.gpu_devices = tuple(gpu_devices)
        self.workers[worker_id.binary()] = handle
        try:
            await asyncio.wait_for(
                handle.ready_event.wait(),
                GLOBAL_CONFIG.get("worker_register_timeout_s"),
            )
        except asyncio.TimeoutError:
            self._kill_worker_proc(handle, "register timeout")
            raise RuntimeError(
                f"worker {worker_id.hex()[:8]} failed to register "
                f"(see {log_base}.err)"
            )
        return handle

    async def _build_worker_env(self, runtime_env: dict):
        """Materialize an isolating runtime env for a fresh worker: the
        content-addressed venv (pip) and/or extracted working_dir. Returns
        (python_exe, cwd). Runs BEFORE the register timeout starts."""
        from ray_tpu_torch._private.runtime_env_mgr import _fetch_extract, ensure_venv

        cache_root = os.path.join(self.session_dir, "runtime_env_cache")
        os.makedirs(cache_root, exist_ok=True)
        python_exe = sys.executable
        pip = runtime_env.get("pip")
        uv = runtime_env.get("uv")
        if pip:
            python_exe = await asyncio.to_thread(
                ensure_venv, list(pip), cache_root)
        elif uv:
            python_exe = await asyncio.to_thread(
                ensure_venv, list(uv), cache_root, "uv")
        cwd = None
        wd_uri = runtime_env.get("working_dir_uri")
        if wd_uri:
            # duck-typed `cw`: _fetch_extract only uses .control.call
            cwd = await _fetch_extract(wd_uri, self, cache_root)
        return python_exe, cwd

    async def rpc_worker_ready(self, conn_id: int, payload: dict) -> dict:
        w = self.workers.get(payload["worker_id"])
        if w is None:
            return {"ok": False, "error": "unknown worker"}
        w.address = payload["address"]
        w.state = W_IDLE
        if not w.reserved:
            self.idle_by_job.setdefault(
                (w.job_id, w.env_key), []).append(w.worker_id.binary())
        w.ready_event.set()
        return {"ok": True}

    def _kill_worker_proc(self, w: WorkerHandle, reason: str):
        if w.state == W_DEAD:
            return
        w.state = W_DEAD
        try:
            os.killpg(os.getpgid(w.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self._forget_worker(w)
        # intentional kills must reach the death records too: owners' borrow
        # reapers free this worker's borrows only on an authoritative notice
        spawn(self._report_worker_death_quiet(w, reason=reason))
        logger.info("killed worker %s: %s", w.worker_id.hex()[:8], reason)

    async def _report_worker_death_quiet(self, w: WorkerHandle,
                                         reason: str = "",
                                         exit_code: Optional[int] = None):
        try:
            await self.control.call(
                "report_worker_death",
                {"worker_id": w.worker_id.binary(), "reason": reason,
                 "exit_code": exit_code}, timeout=10)
        except Exception:  # noqa: BLE001 — control store may be restarting
            logger.debug("report_worker_death failed", exc_info=True)

    def _forget_worker(self, w: WorkerHandle):
        self.workers.pop(w.worker_id.binary(), None)
        idle = self.idle_by_job.get((w.job_id, w.env_key), [])
        if w.worker_id.binary() in idle:
            idle.remove(w.worker_id.binary())
        if w.actor_id is not None:
            # drop the idempotent-create cache entry, or the daemon leaks one
            # completed task per actor ever created on this node
            self._creating_actors.pop(w.actor_id, None)
        if w.gpu_devices:
            self._return_gpus(w.gpu_devices)
            w.gpu_devices = None

    def _alloc_gpus(self, n: int) -> List[int]:
        if len(self._gpu_free) < n:
            raise RuntimeError(
                f"GPU device accounting out of sync: need {n}, "
                f"free {self._gpu_free}"
            )
        devices, self._gpu_free = (
            self._gpu_free[:n], self._gpu_free[n:]
        )
        return devices

    def _return_gpus(self, devices) -> None:
        self._gpu_free.extend(devices)
        self._gpu_free.sort()

    async def _on_worker_death(self, w: WorkerHandle,
                               reason: Optional[str] = None):
        prev_state = w.state
        w.state = W_DEAD
        self._forget_worker(w)
        exit_code = w.proc.poll()
        if exit_code is None:
            # freshly signalled: reap briefly so the death record carries
            # the real exit code instead of None
            try:
                exit_code = await asyncio.to_thread(w.proc.wait, 1.0)
            except subprocess.TimeoutExpired:
                pass
        if reason is None:
            # classify the unexpected exit so downstream errors say WHY
            # (reference: WorkerExitType): SIGKILL with the daemon healthy is
            # almost always the kernel OOM killer or an operator kill
            if exit_code == -signal.SIGKILL:
                reason = "worker killed (SIGKILL: OOM killer or external kill)"
            elif exit_code == 137:
                reason = "worker crashed (exit 137: killed/chaos process_kill)"
            else:
                reason = f"worker process exited ({exit_code})"
        logger.warning(
            "worker %s died (state=%s, code=%s): %s",
            w.worker_id.hex()[:8], prev_state, exit_code, reason,
        )
        flight_recorder.record(
            "worker", "death", worker=w.worker_id.hex()[:8],
            state=prev_state, exit_code=exit_code, reason=reason)
        if w.lease_id is not None:
            self._release_lease(w.lease_id)
        self._release_actor_resources(w)
        # authoritative death record: owners' borrow reapers free this
        # worker's borrows only once the exit is recorded here
        await self._report_worker_death_quiet(w, reason=reason,
                                              exit_code=exit_code)
        if w.actor_id is not None:
            try:
                await self.control.call(
                    "report_actor_death",
                    {"actor_id": w.actor_id, "reason": reason},
                    timeout=10,
                )
            except Exception:  # noqa: BLE001
                logger.exception("failed to report actor death")

    async def _get_idle_worker(
            self, job_id: bytes, env_key: str = "",
            runtime_env: Optional[dict] = None) -> WorkerHandle:
        idle = self.idle_by_job.setdefault((job_id, env_key), [])
        while idle:
            wid = idle.pop()
            w = self.workers.get(wid)
            if w is not None and w.state == W_IDLE and w.proc.poll() is None:
                return w
        # adopt a prestarted generic worker (spawned before any job existed)
        # — only for env-less leases: an env-keyed lease needs a worker
        # built for that env (venv interpreter, working dir)
        generic = self.idle_by_job.get((b"", ""), [])
        while job_id != b"" and env_key == "" and generic:
            wid = generic.pop()
            w = self.workers.get(wid)
            if w is not None and w.state == W_IDLE and w.proc.poll() is None:
                w.job_id = job_id
                return w
        return await self._spawn_worker(job_id, env_key=env_key,
                                        runtime_env=runtime_env)

    def _drop_from_idle(self, w: WorkerHandle):
        idle = self.idle_by_job.get((w.job_id, w.env_key), [])
        if w.worker_id.binary() in idle:
            idle.remove(w.worker_id.binary())

    # ------------------------------------------------------------------
    # lease scheduling (reference: cluster_lease_manager.cc:195)
    # ------------------------------------------------------------------

    async def rpc_request_lease(self, conn_id: int, payload: dict) -> dict:
        # Idempotent by caller-supplied request_key: a client retrying after
        # a timed-out/dropped call must attach to the original request, not
        # queue (and eventually be granted) a second lease (reference:
        # RequestWorkerLease is retried by the retryable grpc client; chaos
        # tests drop it on purpose).
        key = payload.get("request_key")
        if key is None:
            return await self._request_lease_inner(payload)
        if key in self._cancelled_lease_keys:
            # cancelled before this (late/resent) frame arrived: refuse
            # rather than queue a lease nobody will claim
            return {"cancelled": True, "error": "lease request cancelled"}
        task = self._lease_requests.get(key)
        if task is None:
            task = spawn(self._request_lease_inner(payload))
            self._lease_requests[key] = task

            def _settle(t, key=key):
                reply = None if t.cancelled() or t.exception() else t.result()
                if reply is not None and reply.get("granted"):
                    # cache until the lease is released, so late retries see
                    # the same grant instead of double-granting
                    self._lease_key_by_id[reply["lease_id"]] = key
                else:
                    self._lease_requests.pop(key, None)

            task.add_done_callback(_settle)
        return await asyncio.shield(task)

    def _note_infeasible(self, res: ResourceSet):
        """Stamp a lease shape no live node can host (or a draining node
        turned away) for the heartbeat demand signal; entries expire after
        5s unless the retrying client refreshes them."""
        self._infeasible_seen[
            tuple(sorted(res.to_wire().items()))
        ] = time.monotonic()

    async def _request_lease_inner(self, payload: dict) -> dict:
        spec_res = ResourceSet.from_wire(payload["resources"])
        strategy = pb.SchedulingStrategy.from_wire(payload.get("strategy"))
        job_id = payload["job_id"]
        hops = payload.get("hops", 0)
        runtime_env = payload.get("runtime_env") or None
        logger.debug("request_lease res=%s hops=%s", spec_res.to_dict(), hops)

        if strategy.kind == pb.STRATEGY_PLACEMENT_GROUP:
            if self._draining:
                # DrainRaylet rejects all new leases; the caller retries until
                # the node dies and the control store reschedules the PG.
                # Record the shape as demand — the autoscaler must see work
                # a draining node turned away, or it can never undrain us.
                self._note_infeasible(spec_res)
                return {"retry": True, "draining": True}
            return await self._grant_pg_lease(spec_res, strategy, job_id,
                                              runtime_env)

        # Cluster policy: pick the best node; spill if it isn't us.
        if not self._draining:
            choice = self._choose_node(spec_res, strategy)
        else:
            choice = self._choose_node(spec_res, strategy, exclude_self=True)
        my_hex = self.node_id.hex()
        if choice is not None and choice != my_hex:
            if hops < GLOBAL_CONFIG.get("lease_spillback_max_hops"):
                peer = self.peer_nodes.get(choice)
                if peer is not None:
                    return {"spillback": peer.address, "node_id": choice}
            # Hard node affinity to a node we can't reach (unknown peer, dead,
            # or hop cap) must fail, not silently run on the wrong node
            # (reference: node_affinity_scheduling_policy.h — hard affinity to
            # an unavailable node is infeasible).
            if strategy.kind == pb.STRATEGY_NODE_AFFINITY and not strategy.soft:
                return {"infeasible": True,
                        "error": f"node {choice} not available for hard affinity"}
        if choice is None and not self._feasible_anywhere(spec_res, strategy):
            self._note_infeasible(spec_res)
            return {"infeasible": True}
        if self._draining:
            # Never grant locally while draining; the caller retries until the
            # drain finishes or another node has capacity (reference:
            # DrainRaylet rejects new leases during drain). The rejected shape
            # still counts as demand: without it, work only this (draining)
            # node can host is invisible to the autoscaler and the undrain
            # that would unblock it never happens — a livelock.
            self._note_infeasible(spec_res)
            return {"retry": True, "draining": True}
        # Local grant path: queue until available.
        pending = PendingLease(spec_res, strategy, job_id, hops, runtime_env)
        self.pending.append(pending)
        self._try_schedule()
        return await pending.future

    @staticmethod
    def _labels_match(labels: Optional[Dict[str, str]],
                      selector: Optional[Dict[str, str]]) -> bool:
        """One definition of label-selector matching for every scheduling
        decision (choose/grant/spill/feasibility) — shared with the
        control store via pb.labels_match; supports "!value" anti-affinity
        (reference: node_label_scheduling_policy.h)."""
        return pb.labels_match(labels, selector)

    def _choose_node(self, res: ResourceSet, strategy: pb.SchedulingStrategy,
                     exclude_self: bool = False) -> Optional[str]:
        """Hybrid pack/spread over the gossiped view (hybrid_scheduling_policy.h:50)."""
        my_hex = self.node_id.hex()
        if strategy.kind == pb.STRATEGY_NODE_AFFINITY and strategy.node_id:
            return strategy.node_id
        candidates: List[Tuple[float, str]] = []
        view = dict(self.cluster_view)
        view[my_hex] = self.available
        for nid, avail in view.items():
            if exclude_self and nid == my_hex:
                continue
            info = self.peer_nodes.get(nid)
            if info is not None and pb.is_sim_node(info.labels):
                continue  # scale-harness nodes never take real work
            if strategy.label_selector:
                # reference: node_label_scheduling_policy.h:25 — plain
                # tasks select nodes by label. SELF is checked against
                # self.labels (it has no peer_nodes entry); peers with no
                # info yet are skipped rather than matched blindly.
                labels = (self.labels if nid == my_hex
                          else info.labels if info is not None else None)
                if not self._labels_match(labels, strategy.label_selector):
                    continue
            if res.is_subset_of(avail):
                total = info.resources if info else self.total_resources
                denom = max(1, sum(total.to_wire().values()))
                util = 1.0 - sum(avail.to_wire().values()) / denom
                candidates.append((util, nid))
        if not candidates:
            return None
        threshold = GLOBAL_CONFIG.get("scheduler_spread_threshold")
        if strategy.kind == pb.STRATEGY_SPREAD:
            candidates.sort(key=lambda c: c[0])
        else:
            below = [c for c in candidates if c[0] < threshold]
            if below:
                # pack: most utilized under threshold; prefer self on ties
                below.sort(key=lambda c: (-c[0], c[1] != my_hex))
                return below[0][1]
            candidates.sort(key=lambda c: c[0])
        # prefer self on equal footing to avoid pointless spills
        best_util = candidates[0][0]
        for util, nid in candidates:
            if nid == my_hex and util <= best_util + 1e-9:
                return my_hex
        return candidates[0][1]

    def _feasible_anywhere(self, res: ResourceSet,
                           strategy: Optional[pb.SchedulingStrategy] = None
                           ) -> bool:
        selector = strategy.label_selector if strategy is not None else None
        if (self._labels_match(self.labels, selector)
                and res.is_subset_of(self.total_resources)):
            return True
        for nid, info in self.peer_nodes.items():
            if (info.state == pb.NODE_ALIVE
                    and not pb.is_sim_node(info.labels)
                    and self._labels_match(info.labels, selector)
                    and res.is_subset_of(info.resources)):
                return True
        return False

    def _try_schedule(self):
        if not self.pending:
            return
        still: List[PendingLease] = []
        # optimistic view of PEER capacity for spillback of queued leases:
        # deducted as we spill so a burst doesn't all target one peer
        peer_view = {
            nid: avail for nid, avail in self.cluster_view.items()
            if nid != self.node_id.hex()
        }
        hop_cap = GLOBAL_CONFIG.get("lease_spillback_max_hops")
        for p in self.pending:
            if p.future.done():
                continue
            local_ok = self._labels_match(
                self.labels, p.strategy.label_selector)
            if local_ok and p.spec_resources.is_subset_of(self.available):
                self.available = self.available - p.spec_resources
                spawn(self._grant(p, pg_id=None, bundle_index=-1))
                continue
            # locally stuck: a peer (possibly one that just joined — the
            # autoscaler's whole point) may have room now. Re-evaluating
            # queued leases on every schedule tick is what moves demand onto
            # scaled-up nodes (reference: cluster lease manager spillback).
            # Node-affinity leases stay: they queued HERE on purpose.
            if (p.hops < hop_cap
                    and p.strategy.kind in (pb.STRATEGY_DEFAULT,
                                            pb.STRATEGY_SPREAD)):
                target = None
                for nid, avail in peer_view.items():
                    info = self.peer_nodes.get(nid)
                    if info is None or info.state != pb.NODE_ALIVE:
                        continue
                    if pb.is_sim_node(info.labels):
                        continue  # scripted grants must not take real work
                    if not self._labels_match(
                            info.labels, p.strategy.label_selector):
                        continue
                    if p.spec_resources.is_subset_of(avail):
                        target = nid
                        break
                if target is not None:
                    peer_view[target] = peer_view[target] - p.spec_resources
                    p.future.set_result({
                        "spillback": self.peer_nodes[target].address,
                        "node_id": target,
                    })
                    continue
            still.append(p)
        self.pending = still

    async def _grant(self, p: PendingLease, pg_id: Optional[bytes],
                     bundle_index: int = -1):
        n_gpu = int(p.spec_resources.get("GPU"))
        try:
            if n_gpu > 0:
                # CUDA visibility is baked into the worker env at spawn, so
                # a GPU lease always gets a fresh worker bound to its granted
                # device ids (workers holding devices are bound, not pooled)
                from ray_tpu_torch._private.runtime_env_mgr import env_isolation_key

                w = await self._spawn_worker(
                    p.job_id, gpu_devices=self._alloc_gpus(n_gpu),
                    env_key=env_isolation_key(p.runtime_env),
                    runtime_env=p.runtime_env,
                )
            else:
                renv = p.runtime_env
                ekey = (renv or {}).get("env_key", "")
                w = await self._get_idle_worker(p.job_id, ekey, renv)
        except Exception as e:  # noqa: BLE001
            if pg_id is None:
                self.available = self.available + p.spec_resources
            if not p.future.done():
                p.future.set_result({"error": f"worker spawn failed: {e}"})
            return
        lease_id = os.urandom(16)
        w.state = W_LEASED
        w.lease_id = lease_id
        self.leases[lease_id] = (
            w.worker_id.binary(), p.spec_resources, pg_id, bundle_index
        )
        if not p.future.done():
            flight_recorder.record(
                "lease", "grant", worker=w.worker_id.hex()[:8],
                job=p.job_id.hex()[:8])
            p.future.set_result({
                "granted": True,
                "lease_id": lease_id,
                "worker_id": w.worker_id.binary(),
                "worker_address": w.address,
                "node_id": self.node_id.hex(),
                "grant_wait_ns": time.monotonic_ns() - p.t0_ns,
            })
        else:  # caller gave up (timeout) — reclaim
            self._release_lease(lease_id)

    @staticmethod
    def _pg_request_feasible(res: ResourceSet, pg: dict,
                             indices: List[int]) -> bool:
        """True when *res* fits inside the TOTAL reservation of at least
        one candidate bundle — False means the request can NEVER be
        granted from this group (permanent infeasibility, not a
        currently-occupied bundle)."""
        return any(
            i in pg["bundles"] and res.is_subset_of(pg["bundles"][i])
            for i in indices
        )

    async def _grant_pg_lease(self, res: ResourceSet, strategy: pb.SchedulingStrategy,
                              job_id: bytes,
                              runtime_env: Optional[dict] = None) -> dict:
        pg_id = bytes.fromhex(strategy.placement_group_id)
        pg = self.pg_prepared.get(pg_id)
        if pg is None:
            # the bundle lives on another node (a task submitted through
            # this node's daemon): send the request where it is
            peer = await self._pg_bundle_peer(pg_id, strategy.bundle_index)
            if peer is not None:
                return {"spillback": peer.address,
                        "node_id": peer.node_id.hex()}
        if pg is None or pg["state"] != "committed":
            return {"error": "placement group not committed on this node", "retry": True}
        free: Dict[int, ResourceSet] = pg["free"]
        idx = strategy.bundle_index
        indices = [idx] if idx >= 0 else sorted(free.keys())
        for i in indices:
            if i in free and res.is_subset_of(free[i]):
                free[i] = free[i] - res
                p = PendingLease(res, strategy, job_id, 0, runtime_env)
                await self._grant(p, pg_id=pg_id, bundle_index=i)
                reply = await p.future
                if reply.get("granted"):
                    reply["bundle_index"] = i
                else:
                    free[i] = free[i] + res
                return reply
        if not self._pg_request_feasible(res, pg, indices):
            # the request exceeds the bundle's TOTAL reservation: it can
            # never be granted here — surface a permanent infeasibility
            # instead of letting the caller retry forever
            return {"infeasible_in_pg": True,
                    "error": (f"resources {res.to_dict()} exceed the "
                              f"placement group bundle reservation")}
        return {"error": "insufficient placement group resources", "retry": True}

    async def _pg_bundle_peer(self, pg_id: bytes, bundle_index: int):
        """The peer node holding bundle ``bundle_index`` of the placement
        group (any of its bundles for -1), from the control store's
        placements; None while it is unplaced or here."""
        try:
            reply = await self.control.call("get_placement_group",
                                            {"pg_id": pg_id}, timeout=10)
        except Exception:  # noqa: BLE001 — retried by the caller
            return None
        placements = (reply.get("pg") or {}).get("placements") or {}
        nodes = [v for k, v in placements.items()
                 if bundle_index < 0 or int(k) == bundle_index]
        for nid in nodes:
            hexid = nid.hex() if isinstance(nid, bytes) else nid
            if hexid != self.node_id.hex() and hexid in self.peer_nodes:
                return self.peer_nodes[hexid]
        return None

    def _release_lease(self, lease_id: bytes):
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        key = self._lease_key_by_id.pop(lease_id, None)
        if key is not None:
            self._lease_requests.pop(key, None)
        worker_id, res, pg_id, bundle_index = lease
        if pg_id is not None:
            pg = self.pg_prepared.get(pg_id)
            if pg is not None and bundle_index in pg["free"]:
                pg["free"][bundle_index] = pg["free"][bundle_index] + res
        else:
            self.available = self.available + res
        w = self.workers.get(worker_id)
        if w is not None and w.state == W_LEASED:
            if w.gpu_devices:
                # visibility can't be re-narrowed in a live process; retire the
                # worker and return its devices to the pool
                w.lease_id = None
                self._kill_worker_proc(w, "GPU lease returned")
            else:
                w.state = W_IDLE
                w.lease_id = None
                w.reserved = False
                w.idle_since = time.monotonic()
                self.idle_by_job.setdefault(
                    (w.job_id, w.env_key), []).append(worker_id)
        self._try_schedule()

    async def rpc_return_lease(self, conn_id: int, payload: dict) -> dict:
        self._release_lease(payload["lease_id"])
        return {"ok": True}

    async def rpc_cancel_lease_request(self, conn_id: int, payload: dict) -> dict:
        """Release whatever grant `request_key` produced (or will produce):
        the caller lost its connection mid-request_lease and rerouted, so a
        grant under this key is unclaimable — without this it leaks the
        worker forever (reference: NormalTaskSubmitter cancels pending lease
        requests it abandons). Idempotent; unknown keys are a no-op."""
        key = payload.get("request_key")
        if key is not None:
            # tombstone first: a late/resent request_lease frame for this key
            # must be refused even if it has not arrived yet
            self._cancelled_lease_keys[key] = time.monotonic()
            while len(self._cancelled_lease_keys) > 4096:
                self._cancelled_lease_keys.popitem(last=False)
        task = self._lease_requests.get(key) if key is not None else None
        if task is None:
            return {"ok": True}

        def _release(t, key=key):
            reply = None if t.cancelled() or t.exception() else t.result()
            # pop the key directly: in the done-task race window _settle may
            # not have cached the lease_id↔key mapping yet, and relying on
            # _release_lease's map-based pop would leak both entries
            self._lease_requests.pop(key, None)
            if reply is not None and reply.get("granted"):
                self._lease_key_by_id.pop(reply["lease_id"], None)
                self._release_lease(reply["lease_id"])

        # Always via add_done_callback — even for a done task it schedules
        # through call_soon, which queues AFTER any pending _settle callback
        # from rpc_request_lease; running _release first would let _settle
        # re-cache a stale lease_id↔key entry for the released lease.
        task.add_done_callback(_release)
        return {"ok": True}

    async def rpc_kill_worker(self, conn_id: int, payload: dict) -> dict:
        w = self.workers.get(payload["worker_id"])
        if w is None:
            return {"ok": False}
        actor_id = w.actor_id
        w.actor_id = None  # killed on purpose: no death report
        if actor_id is not None:
            self._creating_actors.pop(actor_id, None)
        self._kill_worker_proc(w, payload.get("reason", "kill_worker"))
        if w.lease_id is not None:
            self._release_lease(w.lease_id)
        self._release_actor_resources(w)
        return {"ok": True, "actor_id": actor_id}

    def _release_actor_resources(self, w: WorkerHandle):
        if w.actor_resources is not None:
            if w.actor_pg is not None:
                pg_id, idx = w.actor_pg
                pg = self.pg_prepared.get(pg_id)
                if pg is not None and idx in pg["free"]:
                    pg["free"][idx] = pg["free"][idx] + w.actor_resources
                w.actor_pg = None
            else:
                self.available = self.available + w.actor_resources
            w.actor_resources = None
            self._try_schedule()

    # ------------------------------------------------------------------
    # actor creation (reference: gcs_actor_scheduler.cc:235-387 — here the
    # control store delegates the lease+push to the owning daemon)
    # ------------------------------------------------------------------

    async def rpc_create_actor(self, conn_id: int, payload: dict) -> dict:
        """Idempotent by actor id: the control store retries a timed-out
        create, and the retry must attach to (or observe) the original
        attempt rather than spawn a second worker for the same actor."""
        spec = TaskSpec.from_wire(payload["spec"])
        aid = spec.actor_id.binary()
        task = self._creating_actors.get(aid)
        if task is not None and task.done() and not task.cancelled() \
                and task.exception() is None:
            reply = task.result()
            if reply.get("ok"):
                w = self.workers.get(reply["worker_id"])
                if w is not None and w.state == W_ACTOR and w.proc.poll() is None:
                    return reply  # original create succeeded; worker alive
            task = None  # failed or worker gone: this is a fresh incarnation
        elif task is not None and (task.cancelled() or (
                task.done() and task.exception() is not None)):
            task = None
        if task is None:
            task = spawn(self._create_actor_inner(spec))
            self._creating_actors[aid] = task
        return await asyncio.shield(task)

    async def _create_actor_inner(self, spec: TaskSpec) -> dict:
        # PG-scheduled actors consume their bundle's reservation, not the
        # node's general pool (reference: bundle resource accounting in
        # placement_group_resource_manager.h — same rule as PG leases)
        actor_pg = None
        if spec.strategy.kind == pb.STRATEGY_PLACEMENT_GROUP:
            pg_id = bytes.fromhex(spec.strategy.placement_group_id)
            pg = self.pg_prepared.get(pg_id)
            if pg is None or pg["state"] != "committed":
                return {"ok": False,
                        "error": "placement group not committed on this node"}
            free = pg["free"]
            idx = spec.strategy.bundle_index
            indices = [idx] if idx >= 0 else sorted(free.keys())
            got = None
            for i in indices:
                if i in free and spec.resources.is_subset_of(free[i]):
                    free[i] = free[i] - spec.resources
                    got = i
                    break
            if got is None:
                # transient (bundle currently occupied) vs PERMANENT (the
                # request exceeds the bundle's total reservation — e.g. it
                # asks for a resource the bundle never held): a permanent
                # mismatch must fail the creation loudly, not retry forever
                if not self._pg_request_feasible(
                        spec.resources, pg, indices):
                    return {"ok": False, "permanent": True,
                            "error": (
                                f"resources {spec.resources.to_dict()} exceed "
                                f"the placement group bundle reservation")}
                return {"ok": False,
                        "error": "insufficient resources in placement group bundle"}
            actor_pg = (pg_id, got)
        else:
            if not spec.resources.is_subset_of(self.available):
                return {"ok": False, "error": "insufficient resources"}
            self.available = self.available - spec.resources

        def refund():
            if actor_pg is not None:
                rpg_id, ridx = actor_pg
                rpg = self.pg_prepared.get(rpg_id)
                if rpg is not None and ridx in rpg["free"]:
                    rpg["free"][ridx] = rpg["free"][ridx] + spec.resources
            else:
                self.available = self.available + spec.resources

        n_gpu = int(spec.resources.get("GPU"))
        from ray_tpu_torch._private.runtime_env_mgr import env_isolation_key

        renv = spec.runtime_env or None
        try:
            w = await self._spawn_worker(
                spec.job_id.binary(),
                gpu_devices=self._alloc_gpus(n_gpu) if n_gpu > 0 else None,
                env_key=env_isolation_key(renv),
                runtime_env=renv,
            )
        except Exception as e:  # noqa: BLE001
            refund()
            return {"ok": False, "error": f"worker spawn failed: {e}"}
        # dedicate this worker to the actor
        idle = self.idle_by_job.get((w.job_id, w.env_key), [])
        if w.worker_id.binary() in idle:
            idle.remove(w.worker_id.binary())
        w.state = W_ACTOR
        w.actor_id = spec.actor_id.binary()
        w.drain_coop = bool(spec.drain_cooperative)
        # Mark PG membership BEFORE the init push: a concurrent
        # rpc_return_bundles must see (and kill) this in-flight actor, or the
        # bundle's resources get credited back while the actor keeps running.
        # actor_resources stays None until success so the reap path doesn't
        # double-credit with refund() on an init crash.
        w.actor_pg = actor_pg
        if actor_pg is not None and self.pg_prepared.get(actor_pg[0]) is None:
            # the PG was returned while the worker was spawning
            self._kill_worker_proc(w, "placement group returned during spawn")
            return {"ok": False, "error": "placement group returned"}
        client = RpcClient(w.address, name="daemon->worker")
        try:
            await client.connect()
            reply = await client.call(
                "push_task", {"spec": spec.to_wire()},
                timeout=GLOBAL_CONFIG.get("actor_creation_timeout_s"),
            )
        except Exception as e:  # noqa: BLE001
            self._kill_worker_proc(w, "actor init push failed")
            refund()
            return {"ok": False, "error": f"actor init failed: {e}"}
        finally:
            await client.close()
        if reply.get("error"):
            self._kill_worker_proc(w, "actor __init__ raised")
            refund()
            return {"ok": False, "error": reply["error"].get("traceback", "init failed")}
        if w.state == W_DEAD or (
            actor_pg is not None and self.pg_prepared.get(actor_pg[0]) is None
        ):
            # killed (e.g. the PG was returned) between init and registration
            self._kill_worker_proc(w, "killed during actor init")
            return {"ok": False, "error": "worker killed during actor init"}
        w.actor_resources = spec.resources
        return {
            "ok": True,
            "worker_id": w.worker_id.binary(),
            "worker_address": w.address,
        }

    # ------------------------------------------------------------------
    # placement group bundles (reference: node_manager.proto:515-525)
    # ------------------------------------------------------------------

    async def rpc_prepare_bundles(self, conn_id: int, payload: dict) -> dict:
        pg_id = payload["pg_id"]
        if pg_id in self.pg_prepared:
            # retried prepare (dropped response): already reserved — a second
            # deduction would leak the bundle's resources permanently
            return {"ok": True}
        bundles = [pb.Bundle.from_wire(b) for b in payload["bundles"]]
        need = ResourceSet()
        for b in bundles:
            need = need + b.resources
        if not need.is_subset_of(self.available):
            return {"ok": False}
        self.available = self.available - need
        self.pg_prepared[pg_id] = {
            "state": "prepared",
            "bundles": {b.index: b.resources for b in bundles},
            "free": {b.index: b.resources for b in bundles},
        }
        return {"ok": True}

    async def rpc_commit_bundles(self, conn_id: int, payload: dict) -> dict:
        pg = self.pg_prepared.get(payload["pg_id"])
        if pg is None:
            return {"ok": False}
        pg["state"] = "committed"
        return {"ok": True}

    async def rpc_cancel_bundles(self, conn_id: int, payload: dict) -> dict:
        return await self.rpc_return_bundles(conn_id, payload)

    async def rpc_return_bundles(self, conn_id: int, payload: dict) -> dict:
        pg = self.pg_prepared.pop(payload["pg_id"], None)
        if pg is not None:
            # Workers still leased from these bundles run in resources that
            # are being handed back — kill them before crediting, or the node
            # oversubscribes (their _release_lease path credits nothing once
            # the pg entry is popped).
            for lease_id, (wid, _res, l_pg, _b) in list(self.leases.items()):
                if l_pg == payload["pg_id"]:
                    self.leases.pop(lease_id, None)
                    w = self.workers.get(wid)
                    if w is not None:
                        self._kill_worker_proc(w, "placement group returned")
            # actors living in returned bundles go down with them
            for w in list(self.workers.values()):
                if w.actor_pg is not None and w.actor_pg[0] == payload["pg_id"]:
                    w.actor_pg = None
                    w.actor_resources = None
                    self._kill_worker_proc(w, "placement group returned")
            freed = ResourceSet()
            for res in pg["bundles"].values():
                freed = freed + res
            self.available = self.available + freed
            self._try_schedule()
        return {"ok": True}

    # ------------------------------------------------------------------
    # object spilling (reference: raylet local_object_manager.h:45 —
    # SpillObjects under memory pressure, restore on demand)
    # ------------------------------------------------------------------

    async def _spill_loop(self):
        """Spill cold sealed objects to disk when the store passes the
        high-water mark, down to the low-water mark, so in-store eviction
        (which destroys data) rarely has to fire."""
        period = GLOBAL_CONFIG.get("object_spill_check_period_s")
        high = GLOBAL_CONFIG.get("object_spill_high_water")
        low = GLOBAL_CONFIG.get("object_spill_low_water")
        while not self._stopped:
            await asyncio.sleep(period)
            try:
                st = self.store.stats()
                if st["heap_size"] and st["bytes_in_use"] / st["heap_size"] > high:
                    target = int(st["heap_size"] * low)
                    await self._spill_down_to(target)
            except Exception:  # noqa: BLE001 — keep the loop alive
                logger.exception("spill loop iteration failed")

    async def _spill_down_to(self, target_bytes: int):
        if self._spill_lock is None:
            self._spill_lock = asyncio.Lock()
        async with self._spill_lock:
            spilled_bytes = 0
            for oid, size in self.store.list_evictable(max_n=512):
                st = self.store.stats()
                if st["bytes_in_use"] <= target_bytes:
                    break
                if await self._spill_one(oid):
                    spilled_bytes += size
            if spilled_bytes:
                logger.info(
                    "spilled %.1f MiB to %s (%d objects on disk)",
                    spilled_bytes / 2**20, self.spill_dir, len(self.spilled),
                )

    # ------------------------------------------------------------------
    # memory-pressure worker killing (reference:
    # src/ray/raylet/worker_killing_policy_group_by_owner.h — group tasks
    # by owner, kill the newest member of the largest group so retried
    # work loses the least progress and no single owner is starved)
    # ------------------------------------------------------------------

    def _memory_usage_fraction(self, psutil) -> float:
        limit = GLOBAL_CONFIG.get("memory_limit_bytes")
        if limit <= 0:
            return psutil.virtual_memory().percent / 100.0
        total = 0
        for w in self.workers.values():
            if w.state == W_DEAD:
                continue
            try:
                proc = psutil.Process(w.pid)
                procs = [proc, *proc.children(recursive=True)]
                for p in procs:
                    mi = p.memory_info()
                    # exclude shared pages: every worker maps the same shm
                    # object store, and counting those pages once PER worker
                    # would OOM-kill healthy readers of one big object
                    total += max(0, mi.rss - getattr(mi, "shared", 0))
            except psutil.Error:
                continue
        return total / limit

    def _pick_oom_victim(self) -> Optional[WorkerHandle]:
        """Group-by-owner, newest-first (reference policy): leased task
        workers grouped by job; the largest group loses its newest member —
        running tasks are where the memory is, so reaping them first is the
        only selection that actually relieves pressure (idle workers hold
        ~nothing and would shield a hog forever). Idle workers go only when
        no task runs; actors are never OOM-killed (restart churn)."""
        leased = [w for w in self.workers.values() if w.state == W_LEASED]
        if leased:
            groups: Dict[bytes, List[WorkerHandle]] = {}
            for w in leased:
                groups.setdefault(w.job_id, []).append(w)
            biggest = max(groups.values(), key=len)
            return max(biggest, key=lambda w: w.spawn_ts)
        idle = [w for w in self.workers.values() if w.state == W_IDLE]
        if idle:
            return max(idle, key=lambda w: w.spawn_ts)
        return None

    async def _memory_monitor_loop(self):
        period = GLOBAL_CONFIG.get("memory_monitor_interval_s")
        if period <= 0:
            return
        try:
            import psutil
        except ImportError:
            logger.warning("psutil unavailable; OOM monitor disabled")
            return
        while not self._stopped:
            await asyncio.sleep(period)
            try:
                frac = self._memory_usage_fraction(psutil)
                if frac < GLOBAL_CONFIG.get("memory_usage_threshold"):
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                self._oom_kills += 1
                logger.warning(
                    "memory pressure %.0f%% >= threshold: OOM-killing "
                    "worker %s (state=%s job=%s, newest of largest owner "
                    "group; kill #%d)",
                    frac * 100, victim.worker_id.hex()[:8], victim.state,
                    victim.job_id.hex()[:8], self._oom_kills,
                )
                flight_recorder.record(
                    "oom", "kill_worker", worker=victim.worker_id.hex()[:8],
                    usage_frac=round(frac, 3), kill_no=self._oom_kills)
                lease_id = victim.lease_id
                self._kill_worker_proc(victim, "OOM: node memory pressure")
                if lease_id is not None:
                    # _forget_worker removed it from the reap loop's sight:
                    # credit the lease's resources back ourselves or the
                    # node's capacity shrinks with every OOM kill
                    self._release_lease(lease_id)
            except Exception:  # noqa: BLE001 — monitor must survive
                logger.exception("memory monitor iteration failed")

    def _node_stats(self) -> dict:
        """psutil snapshot shipped with every heartbeat (reference: the
        dashboard agent's reporter module samples cpu/mem/gpu per node)."""
        out: dict = {
            "workers": sum(1 for w in self.workers.values()
                           if w.state != W_DEAD),
            "workers_idle": sum(1 for w in self.workers.values()
                                if w.state == W_IDLE),
            "oom_kills": getattr(self, "_oom_kills", 0),
        }
        if self.store is not None:
            st = self.store.stats()
            out["store_bytes_in_use"] = st["bytes_in_use"]
            out["store_heap_size"] = st["heap_size"]
            out["store_num_objects"] = st["num_objects"]
        try:
            import psutil

            out["cpu_percent"] = psutil.cpu_percent(interval=None)
            vm = psutil.virtual_memory()
            out["mem_percent"] = vm.percent
            out["mem_total"] = vm.total
            rss = 0
            for w in self.workers.values():
                if w.state == W_DEAD:
                    continue
                try:
                    rss += psutil.Process(w.pid).memory_info().rss
                except psutil.Error:
                    continue
            out["workers_rss"] = rss
        except ImportError:
            pass
        return out

    async def rpc_list_workers(self, conn_id: int, payload: dict) -> dict:
        """Live workers on this node (the dashboard's per-node worker table;
        reference: dashboard reporter's worker listing)."""
        return {"workers": [
            {
                "worker_id": w.worker_id.hex(),
                "pid": w.pid,
                "state": w.state,
                "job_id": w.job_id.hex(),
                "env_key": w.env_key,
                "actor_id": w.actor_id.hex() if w.actor_id else "",
            }
            for w in self.workers.values() if w.state != W_DEAD
        ]}

    async def rpc_profile_worker(self, conn_id: int, payload: dict) -> dict:
        """On-demand stack sample of a live worker (reference: the
        dashboard's py-spy/memray profiling,
        dashboard/modules/reporter/profile_manager.py:60-102): SIGUSR1
        dumps all thread stacks, SIGUSR2 dumps asyncio task await-chains —
        both land in the worker's .err log, whose tail is returned."""
        wid = payload["worker_id"]
        if isinstance(wid, str):
            wid = bytes.fromhex(wid)
        w = self.workers.get(wid)
        if w is None or w.state == W_DEAD or w.proc.poll() is not None:
            return {"ok": False, "error": "worker not found or dead"}
        kind = payload.get("kind", "threads")
        sig = signal.SIGUSR2 if kind == "tasks" else signal.SIGUSR1
        log_path = os.path.join(
            self.session_dir, "logs",
            f"worker-{w.worker_id.hex()[:12]}.err")
        try:
            before = os.path.getsize(log_path)
        except OSError:
            before = 0
        try:
            os.kill(w.pid, sig)
        except ProcessLookupError:
            return {"ok": False, "error": "worker died"}
        await asyncio.sleep(0.4)  # dump is async-signal-driven
        try:
            raw = await asyncio.to_thread(
                _read_file_range, log_path, before, 256 * 1024)
            dump = raw.decode("utf-8", "replace")
        except OSError as e:
            return {"ok": False, "error": f"log unreadable: {e}"}
        return {"ok": True, "worker_id": w.worker_id.hex(), "pid": w.pid,
                "kind": kind, "dump": dump}

    async def rpc_spill_now(self, conn_id: int, payload: dict) -> dict:
        """Synchronous spill request from a worker whose create() hit
        ObjectStoreFullError (reference: raylet triggers spilling when a
        plasma allocation stalls)."""
        if not GLOBAL_CONFIG.get("object_spill_enabled"):
            # spilling disabled: the creator's backpressure loop waits for
            # consumers to free refs instead (no spill_dir even exists)
            return {"ok": False, "disabled": True}
        need = payload.get("need_bytes", 0)
        st = self.store.stats()
        low = GLOBAL_CONFIG.get("object_spill_low_water")
        target = min(
            int(st["heap_size"] * low),
            max(0, st["bytes_in_use"] - need),
        )
        await self._spill_down_to(target)
        return {"ok": True}

    @staticmethod
    def _write_file(path: str, view: memoryview):
        with open(path, "wb") as f:
            f.write(view)

    async def _spill_one(self, oid: ObjectID) -> bool:
        res = self.store.get(oid)  # pins
        if res is None:
            return False
        view, meta = res
        path = os.path.join(self.spill_dir, oid.hex())
        try:
            size = len(view)
            # thread: a multi-GiB write must not stall heartbeats/leases
            # (the pin keeps the view valid across the await)
            await asyncio.to_thread(self._write_file, path, view)
        finally:
            view.release()
            self.store.release(oid)
        if not self.store.delete(oid):
            # someone pinned it between our release and delete; keep it in
            # store, drop the file
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        self.spilled[oid.binary()] = (path, meta, size)
        return True

    async def _create_making_room(self, oid: ObjectID, size: int, meta: int):
        """store.create with one retry after spilling `size` bytes of cold
        objects (shared by restore and pull)."""
        try:
            return self.store.create(oid, size, metadata=meta)
        except ObjectStoreFullError:
            st = self.store.stats()
            await self._spill_down_to(max(0, st["bytes_in_use"] - size))
            return self.store.create(oid, size, metadata=meta)

    async def _restore_object(self, oid: ObjectID) -> bool:
        """Bring a spilled object back into the shm store (spilling other
        cold objects out if the store is full)."""
        rec = self.spilled.get(oid.binary())
        if rec is None:
            return self.store.contains(oid)
        path, meta, _size = rec
        if not self.store.contains(oid):
            def read_file():
                with open(path, "rb") as f:
                    return f.read()

            try:
                data = await asyncio.to_thread(read_file)
            except OSError:
                return False
            try:
                view = await self._create_making_room(oid, len(data), meta)
                view[:] = data
                view.release()
                self.store.seal(oid)
            except FileExistsError:
                pass
        self.spilled.pop(oid.binary(), None)
        try:
            os.unlink(path)
        except OSError:
            pass
        return True

    async def rpc_restore_object(self, conn_id: int, payload: dict) -> dict:
        oid = ObjectID(payload["object_id"])
        if self.store.contains(oid):
            return {"ok": True}
        if oid.binary() in self.spilled:
            return {"ok": await self._restore_object(oid)}
        return {"ok": False, "unknown": True}

    # ------------------------------------------------------------------
    # object transfer (reference: object_manager.h:137, pull_manager.h:52)
    # ------------------------------------------------------------------

    async def rpc_fetch_object_info(self, conn_id: int, payload: dict) -> dict:
        oid = ObjectID(payload["object_id"])
        if oid.binary() in self.spilled:
            await self._restore_object(oid)
        res = self.store.get(oid)
        if res is None:
            return {"found": False}
        view, meta = res
        size = len(view)
        view.release()
        self.store.release(oid)
        return {"found": True, "size": size, "metadata": meta}

    async def rpc_fetch_chunk(self, conn_id: int, payload: dict) -> dict:
        oid = ObjectID(payload["object_id"])
        if oid.binary() in self.spilled:
            await self._restore_object(oid)
        res = self.store.get(oid)
        if res is None:
            return {"found": False}
        view, meta = res
        try:
            off, ln = payload["offset"], payload["length"]
            return {"found": True, "data": bytes(view[off : off + ln])}
        finally:
            view.release()
            self.store.release(oid)

    # -- remote-client puts (reference: ray client server-side object puts;
    # a storeless driver ships bytes here instead of mmapping shm) --------

    async def rpc_create_object(self, conn_id: int, payload: dict) -> dict:
        oid = ObjectID(payload["object_id"])
        if self.store.contains(oid) or oid.binary() in self.spilled:
            return {"ok": True, "exists": True}
        if oid.binary() in self._inbound_creates:
            return {"ok": True, "exists": False}
        try:
            view = await self._create_making_room(
                oid, payload["size"], payload.get("meta", 0))
        except FileExistsError:
            return {"ok": True, "exists": True}
        except ObjectStoreFullError as e:
            return {"ok": False, "error": str(e)}
        self._inbound_creates[oid.binary()] = (view, time.monotonic())
        return {"ok": True, "exists": False}

    async def rpc_write_chunk(self, conn_id: int, payload: dict) -> dict:
        entry = self._inbound_creates.get(payload["object_id"])
        if entry is None:
            return {"ok": False, "error": "no in-progress create for object"}
        view, _ = entry
        off = payload["offset"]
        view[off:off + len(payload["data"])] = payload["data"]
        self._inbound_creates[payload["object_id"]] = (view, time.monotonic())
        return {"ok": True}

    async def rpc_seal_object(self, conn_id: int, payload: dict) -> dict:
        entry = self._inbound_creates.pop(payload["object_id"], None)
        if entry is None:
            return {"ok": False, "error": "no in-progress create for object"}
        view, _ = entry
        view.release()
        self.store.seal(ObjectID(payload["object_id"]))
        return {"ok": True}

    def _sweep_stale_inbound_creates(self, max_age_s: float = 60.0):
        """Abort remote-client puts abandoned mid-transfer: release the
        creator pin and delete the unsealed allocation (unsealed entries are
        invisible to eviction/spill, so a leak here is permanent)."""
        if not self._inbound_creates:
            return
        now = time.monotonic()
        for ob, (view, ts) in list(self._inbound_creates.items()):
            if now - ts <= max_age_s:
                continue
            self._inbound_creates.pop(ob, None)
            view.release()
            try:
                self.store.release(ObjectID(ob))
                self.store.delete(ObjectID(ob))
            except Exception:  # noqa: BLE001
                pass
            logger.warning("aborted stale inbound create %s",
                           ObjectID(ob).hex()[:12])

    async def rpc_pull_object(self, conn_id: int, payload: dict) -> dict:
        """Pull an object from a remote node into the local store."""
        oid = ObjectID(payload["object_id"])
        if self.store.contains(oid):
            return {"ok": True}
        if oid.binary() in self.spilled:
            # pulled previously, then spilled: restore from local disk
            return {"ok": await self._restore_object(oid)}
        if payload["from_address"] in self._dead_peer_addrs:
            return {"ok": False,
                    "error": "source node recorded dead by control store"}
        key = oid.binary()
        fut = self._pulls_inflight.get(key)
        if fut is None:
            fut = spawn(self._do_pull(oid, payload["from_address"]))
            self._pulls_inflight[key] = fut
        try:
            await fut
            return {"ok": True}
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": str(e)}
        finally:
            self._pulls_inflight.pop(key, None)

    async def _do_pull(self, oid: ObjectID, from_address: str):
        client = self._peer_clients.get(from_address)
        if client is None:
            client = RpcClient(from_address, name="daemon->peer")
            await client.connect()
            self._peer_clients[from_address] = client
        delay = GLOBAL_CONFIG.get("pull_retry_initial_delay_s")
        max_delay = GLOBAL_CONFIG.get("pull_retry_max_delay_s")
        deadline = time.monotonic() + 60
        while True:
            info = await client.call("fetch_object_info", {"object_id": oid.binary()})
            if info.get("found"):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"object {oid} never appeared on {from_address}")
            await asyncio.sleep(delay)
            delay = min(delay * 2, max_delay)
        size, meta = info["size"], info["metadata"]
        try:
            view = await self._create_making_room(oid, size, meta)
        except FileExistsError:
            return
        # Parallel chunk fetch (reference: push_manager chunking).
        from ray_tpu_torch.runtime.transfer import fetch_chunks

        try:
            await fetch_chunks(
                client.call, oid.binary(), size, view,
                chunk_bytes=GLOBAL_CONFIG.get("object_chunk_bytes"),
            )
        except Exception:
            view.release()
            # the creator ref is only dropped by seal; release it first or
            # delete refuses (pinned) and the unsealed allocation leaks
            self.store.release(oid)
            self.store.delete(oid)
            raise
        view.release()
        self.store.seal(oid)

    async def rpc_free_objects(self, conn_id: int, payload: dict) -> dict:
        for ob in payload["object_ids"]:
            self.store.delete(ObjectID(ob))
            rec = self.spilled.pop(ob, None)
            if rec is not None:
                try:
                    os.unlink(rec[0])
                except OSError:
                    pass
        return {"ok": True}

    async def rpc_store_stats(self, conn_id: int, payload) -> dict:
        st = self.store.stats()
        st["spilled_objects"] = len(self.spilled)
        st["spilled_bytes"] = sum(r[2] for r in self.spilled.values())
        return st

    async def rpc_node_info(self, conn_id: int, payload) -> dict:
        return {
            "node_id": self.node_id.hex(),
            "address": self.address,
            "store_name": self.store_name,
            "available": self.available.to_wire(),
            "total": self.total_resources.to_wire(),
            "num_workers": len(self.workers),
            "num_pending_leases": len(self.pending),
        }

    async def rpc_ping(self, conn_id: int, payload) -> dict:
        """Liveness probe for worker fate-sharing watchdogs."""
        return {"ok": True}

    # -- chaos scenario hooks (testing only; reference: rpc_chaos.h is
    # env-driven — these add runtime aim-ability, since daemon/worker
    # addresses are only known after spawn) -----------------------------

    # ------------------------------------------------------------------
    # metrics pre-aggregation + flight recorder (observability plane)
    # ------------------------------------------------------------------

    async def rpc_report_metrics(self, conn_id: int, payload: dict) -> dict:
        """Per-node metric aggregation point: every worker's delta series
        merge into one node-level pending set (counters/histograms add,
        gauges replace), capped in cardinality — the control store sees one
        reporter per NODE, not one per worker (reference: the per-node
        metrics agent in dashboard/modules/reporter)."""
        from ray_tpu_torch.util.metrics import merge_series

        series = payload.get("metrics") or []
        delta = bool(payload.get("delta"))
        seq = payload.get("seq")
        reporter = payload.get("worker_id", b"")
        if delta and seq is not None:
            last = self._metrics_last_seq.get(reporter)
            if last is not None and seq <= last:
                return {"ok": True, "dup": True}
            self._metrics_last_seq[reporter] = seq
            self._metrics_last_seq.move_to_end(reporter)
            while len(self._metrics_last_seq) > 4096:
                self._metrics_last_seq.popitem(last=False)
        cap = GLOBAL_CONFIG.get("metrics_node_series_max")
        admitted = []
        for s in series:
            try:
                key = (s["name"], tuple(sorted(s["tags"].items())))
            except (KeyError, TypeError, AttributeError):
                continue
            if key not in self._metrics_keys:
                if len(self._metrics_keys) >= cap:
                    self._metrics_dropped += 1
                    continue
                self._metrics_keys.add(key)
            admitted.append(s)
        merge_series(self._metrics_pending, admitted, delta)
        return {"ok": True, "dropped_total": self._metrics_dropped}

    async def _metrics_ship_loop(self):
        """Forward the node's pending metric deltas (plus this daemon's own
        registry and the cardinality-drop counter) to the control store."""
        from ray_tpu_torch.util import metrics as metrics_mod

        period = GLOBAL_CONFIG.get("telemetry_flush_period_s")
        # eagerly registered at zero so the series exists on the scrape
        # before the first drop happens
        dropped_counter = metrics_mod.get_or_create_counter(
            "rt_metrics_series_dropped_total",
            "Metric series dropped by the node daemon's cardinality cap "
            "(metrics_node_series_max)")
        dropped_counter.inc(0)
        shipped_drops = 0
        # frozen outbound batch (exactly-once: same seq retried verbatim
        # until the store acks; the store dedups by (node, seq))
        batch: Optional[list] = None  # [seq, series]
        seq = 0
        while not self._stopped:
            await asyncio.sleep(period)
            try:
                if self._metrics_dropped > shipped_drops:
                    metrics_mod.get_or_create_counter(
                        "rt_metrics_series_dropped_total").inc(
                            self._metrics_dropped - shipped_drops)
                    shipped_drops = self._metrics_dropped
                if batch is None:
                    own = metrics_mod.take_delta()
                    pending, self._metrics_pending = (
                        self._metrics_pending, {})
                    series = list(pending.values()) + own
                    if series:
                        seq += 1
                        batch = [seq, series]
                # an idle interval still sends an empty keepalive: the
                # store's stale prune must not collect this node's
                # accumulated totals while it merely has nothing new
                payload = {"worker_id": self.node_id.binary(),
                           "delta": True,
                           "metrics": batch[1] if batch else [],
                           **({"seq": batch[0]} if batch else {})}
                try:
                    await self.control.call(
                        "report_metrics", payload, timeout=10)
                    batch = None
                except Exception:  # noqa: BLE001 — store blip: the frozen
                    # batch retries with the same seq next tick (new worker
                    # reports keep accumulating in _metrics_pending)
                    pass
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — telemetry must never kill
                logger.debug("metrics ship loop error", exc_info=True)

    async def rpc_dump_flight_recorder(self, conn_id: int, payload) -> dict:
        return flight_recorder.dump()

    async def rpc_collect_flight_recorders(self, conn_id: int,
                                           payload) -> dict:
        """This daemon's ring plus every live local worker's — the one-stop
        per-node pull the dashboard's /api/flight_recorder endpoint and the
        cluster-wide dump use."""
        out = {"daemon": flight_recorder.dump(), "workers": {}}
        for w in list(self.workers.values()):
            if w.state == W_DEAD or not w.address:
                continue
            try:
                client = RpcClient(w.address, name="daemon->worker-fr",
                                   retries=0)
                await client.connect()
                try:
                    out["workers"][w.worker_id.hex()] = await client.call(
                        "dump_flight_recorder", {}, timeout=5)
                finally:
                    await client.close()
            except Exception as e:  # noqa: BLE001 — wedged worker: skip it
                logger.debug("flight-recorder pull from worker %s skipped: %r",
                             w.worker_id.hex()[:12], e)
                continue
        return out

    async def rpc_chaos_set(self, conn_id: int, payload: dict) -> dict:
        """Apply chaos/testing config flags to THIS daemon process at
        runtime (e.g. partition it from one peer address)."""
        cfg = payload.get("config", {})
        GLOBAL_CONFIG.apply_system_config(cfg)
        chaos.reset()
        # a wave spec landing at runtime re-runs the seeded draw NOW, so a
        # test can aim a correlated reclaim at a fleet that is already
        # mid-workload (the start()-time draw only covers daemons born
        # after the spec was set)
        if cfg.get("testing_preempt_wave"):
            wave = chaos.preempt_wave(
                self.labels.get("spot") == "true"
                or self.labels.get("preemptible") == "true")
            if wave is not None:
                offset_s, deadline_s = wave
                self._tasks.append(
                    spawn(self._chaos_preempt(offset_s, deadline_s)))
        return {"ok": True, "role": chaos.role(), "pid": os.getpid()}

    async def rpc_chaos_kill(self, conn_id: int, payload: dict) -> dict:
        """Kill a chosen worker process (by id, or any one leased/idle
        worker), or this daemon itself — the process-kill fault type aimed
        at a specific live process."""
        if payload.get("die"):
            # reply first so the injector isn't stuck on a lost RPC; the
            # exit runs after the response flushes. Crash path = flight
            # recorder dump: the post-mortem artifact survives the process.
            flight_recorder.crash_dump("chaos_kill")
            asyncio.get_running_loop().call_later(0.05, os._exit, 137)
            return {"ok": True, "target": "daemon"}
        wid = payload.get("worker_id")
        victims = [w for w in self.workers.values() if w.state != W_DEAD
                   and (wid is None or w.worker_id.binary() == wid)
                   and (not payload.get("actor") or w.state == W_ACTOR)]
        if not victims:
            return {"ok": False, "error": "no matching live worker"}
        victim = victims[0]
        # simulate a CRASH, not an administrative kill: SIGKILL the process
        # and run the same observation path the reap loop takes, so actor
        # death / lease release / death records all fire exactly as they
        # would for a real unexpected exit
        try:
            os.killpg(os.getpgid(victim.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        await self._on_worker_death(victim,
                                    reason="worker crashed (chaos process_kill)")
        return {"ok": True, "target": victim.worker_id.hex()}

    async def rpc_drain(self, conn_id: int, payload) -> dict:
        """Graceful drain (reference: DrainRaylet node_manager.proto:510)
        carrying `{reason, deadline_s}`. Routed through the control store so
        the cluster-wide record agrees — a locally-set flag alone would be
        reverted by the next heartbeat's authoritative state sync. With a
        deadline the drain is terminal: the daemon finishes running work,
        replicates its primary copies, and exits with an expected-
        termination death record."""
        payload = payload or {}
        reason = payload.get("reason") or pb.DRAIN_REASON_MANUAL
        deadline_s = float(payload.get("deadline_s") or 0.0)
        return await self._self_drain(reason, deadline_s)

    async def _self_drain(self, reason: str, deadline_s: float) -> dict:
        flight_recorder.record("drain", "start", reason=reason,
                               deadline_s=deadline_s)
        try:
            await self.control.call(
                "drain_node",
                {"node_id": self.node_id.binary(), "reason": reason,
                 "deadline_s": deadline_s},
                timeout=10,
            )
        except Exception as e:  # noqa: BLE001 — partitioned from the store
            # a preemption notice is real whether or not the control store
            # heard about it: gate leases and run the orchestration locally;
            # unregister_node (retried inside) records the death when the
            # partition heals
            logger.warning("drain_node RPC failed (%s); draining locally", e)
            self._draining = True
            self._drain_sync_ts = time.monotonic()
            if deadline_s and self._drain_task is None:
                self._drain_task = spawn(self._drain_and_exit(
                    reason, time.monotonic() + deadline_s))
            # keep trying to file the drain cluster-wide: owners only
            # reroute leases/retries away from this node once the store
            # publishes the DRAINING notice
            spawn(self._register_drain_late(reason, deadline_s))
            return {"ok": True, "local_only": True}
        info = NodeInfo.from_wire(self._node_info.to_wire())
        info.state = pb.NODE_DRAINING
        info.drain_reason = reason
        info.drain_deadline = time.time() + deadline_s if deadline_s else 0.0
        self._sync_drain_state(info)
        return {"ok": True}

    async def _register_drain_late(self, reason: str, deadline_s: float):
        """A locally-initiated drain whose drain_node RPC failed (store
        partitioned at notice time) retries the cluster-wide registration
        until it lands or the drain budget runs out — without it no
        DRAINING notice ever tells owners to reroute. The retry budget is
        independent of the drain semantics: a reversible drain
        (deadline_s == 0) must stay reversible, so the registration
        forwards the ORIGINAL deadline (remaining wall-clock time for a
        terminal drain, 0.0 unchanged for a reversible one) — never the
        retry-loop budget."""
        drain_deadline = (
            time.monotonic() + deadline_s if deadline_s else None)
        retry_until = time.monotonic() + max(deadline_s, 10.0)
        while time.monotonic() < retry_until and not self._stopped:
            await asyncio.sleep(1.0)
            if (drain_deadline is not None
                    and time.monotonic() >= drain_deadline):
                # the node is about to exit anyway; the expected-death
                # unregister tells the cluster the story
                return
            try:
                await self.control.call(
                    "drain_node",
                    {"node_id": self.node_id.binary(), "reason": reason,
                     "deadline_s": (
                         max(0.1, drain_deadline - time.monotonic())
                         if drain_deadline is not None else 0.0)},
                    timeout=5,
                )
                return
            except Exception:  # noqa: BLE001 — still partitioned
                continue

    # ------------------------------------------------------------------
    # terminal drain orchestration (reference: the raylet's drain handling
    # — stop granting, let running leases finish to the deadline, hand off
    # primary copies, then die an EXPECTED death)
    # ------------------------------------------------------------------

    def _make_preempt_watcher(self, deadline_s: Optional[float] = None,
                              transport=None):
        """One construction site for real and synthetic preemption notices
        so both take the identical proactive path: publish the TTL'd
        notice, keep re-publishing (failover-proof), self-drain only when
        the control plane misses the grace window."""
        from ray_tpu_torch.gpu.preemption import PreemptionWatcher

        return PreemptionWatcher(
            on_notice=self._self_drain,
            transport=transport,
            drain_deadline_s=deadline_s,
            publish=self._publish_preempt_notice,
            drain_started=lambda: self._draining or self._drain_task is not None,
        )

    async def _publish_preempt_notice(self, deadline_s: float) -> None:
        """File/refresh this node's TTL'd preemption notice at the control
        store (PREEMPTING state; the autoscaler treats our committed load
        as demand NOW). Raises on failure so the watcher retries."""
        reply = await self.control.call(
            "report_preemption_notice",
            {"node_id": self.node_id.binary(), "deadline_s": deadline_s},
            timeout=5,
        )
        if not reply.get("ok"):
            raise RuntimeError(f"report_preemption_notice refused: {reply}")

    async def _chaos_preempt(self, delay_s: float, deadline_s: float):
        """Seeded `testing_preempt_notice`/`testing_preempt_wave` fault: a
        deterministic stand-in for the GCE maintenance event — the notice
        lands mid-workload and must produce a non-event, not a recovery
        storm. Routed through the watcher's fire path so proactive mode
        (publish + pre-provision + deferred drain) is exercised exactly as
        a real metadata notice would."""
        await asyncio.sleep(delay_s)
        logger.warning("synthetic preemption notice (chaos): %.1fs deadline",
                       deadline_s)
        self._preempt_watcher = self._make_preempt_watcher(
            deadline_s=deadline_s)
        await self._preempt_watcher._fire("synthetic preemption (chaos)")

    async def _drain_and_exit(self, reason: str, deadline: float):
        try:
            # the deadline is HARD (a preempted VM is killed at it): budget
            # the phases inside it instead of letting a long-running lease
            # starve the replication/report handoff that makes the drain
            # cheap. The final control calls are small — reserve a tail
            # slice; everything clamps to the overall deadline.
            budget = max(0.0, deadline - time.monotonic())
            lease_deadline = time.monotonic() + budget * 0.6
            report_deadline = min(deadline, time.monotonic() + 30.0)
            await self._wait_for_leases(lease_deadline)
            replicas = await self._replicate_primaries(
                max(time.monotonic(), deadline - min(5.0, budget * 0.1)))
            if replicas:
                try:
                    # deadline-retried: a control-store failover mid-drain
                    # must not lose the replica map (owners would fall back
                    # to reconstructing everything)
                    await self.control.call(
                        "report_drain_replicas",
                        {"node_id": self.node_id.binary(),
                         "replicas": replicas},
                        timeout=10,
                        deadline=max(report_deadline,
                                     time.monotonic() + 2.0),
                    )
                except Exception:  # noqa: BLE001 — store blip: replicas
                    # still exist, owners just reconstruct instead
                    logger.warning("report_drain_replicas failed",
                                   exc_info=True)
            try:
                await self.control.call(
                    "unregister_node",
                    {"node_id": self.node_id.binary(), "expected": True,
                     "reason": f"drained ({reason})"},
                    timeout=10,
                    deadline=max(min(deadline, time.monotonic() + 30.0),
                                 time.monotonic() + 2.0),
                )
            except Exception:  # noqa: BLE001 — health checker will record
                # an (unexpected) death instead; replicas still serve
                logger.warning("drain unregister_node failed", exc_info=True)
            logger.info("drain complete (%s): exiting", reason)
            flight_recorder.record("drain", "complete", reason=reason,
                                   replicas=len(replicas or {}))
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — never die silently mid-drain
            logger.exception("drain orchestration failed; exiting anyway")
            flight_recorder.crash_dump("drain_failed")
        finally:
            self._stopped = True
            if self._exit_cb is not None:
                self._exit_cb()

    async def _wait_for_leases(self, deadline: float):
        """Let running work finish: leases stop being granted the moment the
        drain notice lands, so the busy set only shrinks.

        ACTOR workers hold the node open too — but only those some
        protocol will actually remove: the control store migrates non-PG
        actors immediately, and a `drain_cooperative` actor's owner runs
        its own removal (the elastic train controller live-shrinks its
        gang and releases the doomed ranks, killing their workers).
        Exiting the moment no TASK lease runs would strand those
        protocols with a dead node mid-handoff; a node hosting only
        actors would get no warning at all. PG-pinned non-cooperative
        actors are NOT waited for — nothing removes them before node
        death, and idling on them would eat the replication window that
        keeps the drain zero-reconstruction."""
        while time.monotonic() < deadline:
            busy = [w for w in self.workers.values()
                    if w.state == W_LEASED
                    or (w.state == W_ACTOR
                        and (w.actor_pg is None or w.drain_coop))]
            if not busy and not self.leases:
                return
            await asyncio.sleep(0.05)
        leased = [w for w in self.workers.values() if w.state == W_LEASED]
        actors = [w for w in self.workers.values() if w.state == W_ACTOR]
        if leased or actors:
            logger.warning(
                "drain deadline reached with %d lease(s) and %d actor "
                "worker(s) still running; tasks retry elsewhere, actors "
                "die with the node", len(leased), len(actors))

    async def _replicate_primaries(self, deadline: float) -> dict:
        """Proactively copy store-resident (and spilled) objects to live
        peers so owners fail over to the replicas with ZERO lineage
        reconstructions (reference: the object manager's primary-copy
        handoff on drain). Returns {oid_hex: {"node_id", "daemon"}}."""
        peers = [
            info for hexid, info in self.peer_nodes.items()
            if info.state == pb.NODE_ALIVE and hexid != self.node_id.hex()
        ]
        if not peers or self.store is None:
            return {}
        cap = GLOBAL_CONFIG.get("drain_replicate_max_objects")
        oids = [oid for oid, _sz in self.store.list_evictable(max_n=cap)]
        seen = {o.binary() for o in oids}
        spill_extra = [ob for ob in list(self.spilled) if ob not in seen]
        oids.extend(ObjectID(ob) for ob in spill_extra)  # restored on fetch
        # the evictable listing is itself capped at `cap`: count candidates
        # from the store's total object count so objects past the listing
        # cap are not silently missing from the dropped tally
        total = (self.store.stats().get("num_objects", len(oids))
                 + len(spill_extra))
        if len(oids) > cap:
            oids = oids[:cap]
        dropped = total - len(oids)
        if dropped > 0:
            logger.warning(
                "drain: %d object(s) beyond the replicate cap will rely on "
                "lineage reconstruction", dropped)
        replicas: dict = {}

        async def replicate_one(i: int, oid: ObjectID):
            peer = peers[i % len(peers)]
            try:
                client = self._peer_clients.get(peer.address)
                if client is None:
                    client = RpcClient(peer.address, name="daemon->peer")
                    await client.connect()
                    self._peer_clients[peer.address] = client
                r = await client.call(
                    "pull_object",
                    {"object_id": oid.binary(), "from_address": self.address},
                    timeout=max(1.0, min(30.0, deadline - time.monotonic())),
                )
                if r.get("ok"):
                    replicas[oid.hex()] = {
                        "node_id": peer.node_id.hex(),
                        "daemon": peer.address,
                    }
            except Exception:  # noqa: BLE001 — this object reconstructs
                logger.debug("drain replication of %s failed",
                             oid.hex()[:12], exc_info=True)

        batch = 16
        for b0 in range(0, len(oids), batch):
            if time.monotonic() >= deadline:
                logger.warning(
                    "drain deadline reached mid-replication: %d object(s) "
                    "unreplicated will rely on lineage reconstruction",
                    len(oids) - b0)
                break
            await asyncio.gather(*[
                replicate_one(b0 + j, oid)
                for j, oid in enumerate(oids[b0:b0 + batch])
            ])
        if replicas:
            logger.info("drain: replicated %d/%d primary object(s) to %d "
                        "peer(s)", len(replicas), len(oids), len(peers))
        return replicas


async def run_daemon(args):
    daemon = NodeDaemon(
        control_address=args.control_address,
        resources=json.loads(args.resources) if args.resources else None,
        labels=json.loads(args.labels) if args.labels else None,
        session_dir=args.session_dir,
        store_name=args.store_name or None,
    )
    addr = await daemon.start(args.port)
    if args.ready_file:
        # rtlint: disable=R001 one-shot startup marker write before the daemon serves traffic
        with open(args.ready_file, "w") as f:
            json.dump(
                {
                    "address": addr,
                    "node_id": daemon.node_id.hex(),
                    "store_name": daemon.store_name,
                },
                f,
            )
    stop = asyncio.Event()
    # a completed terminal drain exits the daemon process cleanly (the
    # expected-termination record is already filed with the control store)
    daemon._exit_cb = stop.set

    def _term(*_):
        stop.set()

    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, _term)
    await stop.wait()
    await daemon.stop()


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--control-address", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources", default="")
    parser.add_argument("--labels", default="")
    parser.add_argument("--session-dir", default="/tmp/ray_tpu_sessions")
    parser.add_argument("--store-name", default="")
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--config-json", default="")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args()
    logging.basicConfig(
        level=os.environ.get("RT_LOG_LEVEL", args.log_level),
        format="%(asctime)s %(levelname)s daemon %(message)s",
    )
    if args.config_json:
        GLOBAL_CONFIG.load_overrides(args.config_json)
    try:
        asyncio.run(run_daemon(args))
    except KeyboardInterrupt:
        pass
    except BaseException:
        # fatal daemon crash: leave the flight-recorder ring next to the
        # logs before propagating (the post-mortem artifact)
        from ray_tpu_torch._private import flight_recorder as _fr

        _fr.crash_dump("daemon_fatal")
        raise


if __name__ == "__main__":
    main()
