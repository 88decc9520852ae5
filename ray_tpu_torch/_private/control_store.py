"""Control store — the cluster control plane (GCS equivalent).

Capability parity with the reference's GCS server (reference:
src/ray/gcs/gcs_server.h:99, wiring gcs_server.cc:260-341): one process per
cluster holding the authoritative tables for nodes, jobs, actors, placement
groups, KV, and task events, plus pub/sub fan-out and node health checking
(reference: src/ray/gcs/gcs_health_check_manager.h). Redesigned on the asyncio
msgpack RPC transport (runtime/rpc.py) instead of 13 gRPC services.

Actor lifecycle mirrors GcsActorManager/GcsActorScheduler
(src/ray/gcs/actor/gcs_actor_manager.h:94, gcs_actor_scheduler.h:104): actors
are registered by their owner, scheduled onto a node chosen from the live
resource view, created by asking that node's daemon to lease a worker, and
restarted on failure up to max_restarts.

Placement groups use the same 2-phase prepare/commit over node daemons as the
reference (node_manager.proto:515-525, gcs_placement_group_manager.h).
"""

from __future__ import annotations

import asyncio
import collections
from ray_tpu_torch._private.aio import spawn
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private import protocol as pb
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.errors import RpcError
from ray_tpu_torch._private.persistence import FencedError
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch._private.protocol import NodeInfo, ResourceSet, TaskSpec
from ray_tpu_torch.runtime.rpc import RpcClient, RpcServer

logger = logging.getLogger(__name__)


class PubSub:
    """Channel-based pub/sub over server push frames.

    Replaces the reference's long-poll publisher (src/ray/pubsub/publisher.h:357):
    the asyncio transport supports unsolicited server->client frames, so
    subscriptions are plain push registrations, no polling.

    Scale plane: with `pubsub_flush_window_ms` > 0, notices buffer per
    subscriber and ship as ONE batched frame per subscriber per window
    (a 1000-node churn wave costs frames proportional to windows, not
    events). The per-subscriber backlog is BOUNDED (`pubsub_max_backlog`):
    a stalled subscriber sheds oldest-first with drops counted in
    `rt_pubsub_dropped_total{channel=}`, and the shed shows up client-side
    as a `_seq` gap that triggers a cursor reconcile — loss is loud and
    recoverable, never an unbounded queue.
    """

    def __init__(self, server: RpcServer):
        self._server = server
        self._subs: Dict[str, Set[int]] = {}
        # per-channel monotonic publish sequence (gap detection): every
        # notice is stamped with `_seq`; subscribers track the last seq they
        # saw — a reconnect whose subscribe-reply seq doesn't match, or an
        # in-stream seq jump (backlog shed), runs a table reconcile. A death
        # published during a control-store failover window must not be
        # silently lost.
        self.seq: Dict[str, int] = {}
        # coalescing plane: conn_id -> pending (channel, message) deque
        self._pending: Dict[int, collections.deque] = {}
        self._flusher: Optional[asyncio.Task] = None
        self.dropped: Dict[str, int] = {}
        self._drop_counter = None

    def subscribe(self, conn_id: int, channel: str) -> None:
        self._subs.setdefault(channel, set()).add(conn_id)

    def channel_seq(self, channel: str) -> int:
        return self.seq.get(channel, 0)

    def unsubscribe_conn(self, conn_id: int) -> None:
        for subs in self._subs.values():
            subs.discard(conn_id)
        self._pending.pop(conn_id, None)

    def _drop(self, channel: str, n: int = 1) -> None:
        self.dropped[channel] = self.dropped.get(channel, 0) + n
        if self._drop_counter is None:
            from ray_tpu_torch.util.metrics import get_or_create_counter

            self._drop_counter = get_or_create_counter(
                "rt_pubsub_dropped_total",
                "Pubsub notices shed because a subscriber's bounded backlog "
                "(pubsub_max_backlog) was full; the subscriber reconciles "
                "from its cursor on the resulting _seq gap.",
                tag_keys=("channel",))
        self._drop_counter.inc(n, tags={"channel": channel})

    def publish(self, channel: str, message: Any) -> None:
        self.seq[channel] = seq = self.seq.get(channel, 0) + 1
        if isinstance(message, dict):
            message = {**message, "_seq": seq}
        subs = self._subs.get(channel)
        if not subs:
            return
        backlog = GLOBAL_CONFIG.get("pubsub_max_backlog")
        if GLOBAL_CONFIG.get("pubsub_flush_window_ms") > 0:
            for conn_id in list(subs):
                q = self._pending.setdefault(conn_id, collections.deque())
                if len(q) >= backlog:
                    # shed OLDEST: later node-table notices supersede
                    # earlier ones, and the subscriber detects the hole by
                    # _seq and reconciles from its delta cursor
                    old_channel, _ = q.popleft()
                    self._drop(old_channel)
                q.append((channel, message))
            self._ensure_flusher()
            return
        # immediate mode (legacy): one frame per event, but a stalled
        # subscriber's transport buffer must not grow without bound — past
        # ~1KiB * backlog of unsent bytes, shed instead of buffering
        cap_bytes = backlog * 1024
        for conn_id in list(subs):
            if self._server.conn_buffer_size(conn_id) > cap_bytes:
                self._drop(channel)
                continue
            if not self._server.push(conn_id, channel, message):
                subs.discard(conn_id)

    def _ensure_flusher(self) -> None:
        if self._flusher is None or self._flusher.done():
            self._flusher = spawn(self._flush_loop())

    async def _flush_loop(self):
        window_s = GLOBAL_CONFIG.get("pubsub_flush_window_ms") / 1000.0
        while self._pending:
            await asyncio.sleep(max(window_s, 1e-4))
            self.flush()

    def flush(self) -> None:
        """Ship every subscriber's pending batch as one frame. Subscribers
        whose transport is still backed up keep their (bounded) backlog for
        the next window instead of stacking bytes on a dead socket."""
        cap_bytes = GLOBAL_CONFIG.get("pubsub_max_backlog") * 1024
        for conn_id in list(self._pending):
            q = self._pending.get(conn_id)
            if not q:
                self._pending.pop(conn_id, None)
                continue
            if self._server.conn_buffer_size(conn_id) > cap_bytes:
                continue
            items = list(q)
            q.clear()
            self._pending.pop(conn_id, None)
            if not self._server.push_batch(conn_id, items):
                self.unsubscribe_conn(conn_id)


class ActorRecord:
    __slots__ = (
        "spec", "state", "node_id", "worker_id", "worker_address",
        "num_restarts", "planned_restarts", "death_cause", "name",
        "pending_create",
    )

    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.state = pb.ACTOR_PENDING
        self.node_id: Optional[bytes] = None
        self.worker_id: Optional[bytes] = None
        self.worker_address: str = ""
        self.num_restarts = 0
        # restarts caused by planned node removal (drain/preemption): they
        # advance the incarnation like any restart (ordering semantics) but
        # never charge the user's max_restarts budget — planned failure must
        # be cheap (reference: NodeDeathInfo-driven restart accounting)
        self.planned_restarts = 0
        self.death_cause = ""
        self.name = spec.name
        self.pending_create: Optional[asyncio.Task] = None

    def to_wire(self) -> dict:
        return {
            "actor_id": self.spec.actor_id.binary(),
            "state": self.state,
            "node_id": self.node_id or b"",
            "worker_id": self.worker_id or b"",
            "worker_address": self.worker_address,
            "num_restarts": self.num_restarts,
            "planned_restarts": self.planned_restarts,
            "death_cause": self.death_cause,
            "name": self.name,
            "class_key": self.spec.function_key,
            "max_task_retries": self.spec.max_task_retries,
            "method_meta": self.spec.method_meta,
            # concurrent actors (async / threaded / concurrency groups)
            # overlap executions, so owners must not couple their replies
            # into batched pushes (head-of-line blocking)
            "concurrent": bool(
                self.spec.is_async_actor
                or self.spec.max_concurrency > 1
                or self.spec.concurrency_groups
            ),
        }

    def to_persist(self) -> dict:
        return {"spec": self.spec.to_wire(), **self.to_wire()}

    @classmethod
    def from_persist(cls, d: dict) -> "ActorRecord":
        rec = cls(TaskSpec.from_wire(d["spec"]))
        rec.apply_update(d)
        return rec

    def apply_update(self, d: dict):
        self.state = d["state"]
        self.node_id = d["node_id"] or None
        self.worker_id = d["worker_id"] or None
        self.worker_address = d["worker_address"]
        self.num_restarts = d["num_restarts"]
        self.planned_restarts = d.get("planned_restarts", 0)
        self.death_cause = d["death_cause"]


class PlacementGroupRecord:
    __slots__ = (
        "pg_id", "bundles", "strategy", "state", "placements", "name",
        "label_selector",
    )

    def __init__(self, pg_id: PlacementGroupID, bundles: List[pb.Bundle],
                 strategy: str, name: str,
                 label_selector: Optional[Dict[str, str]] = None):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.state = pb.PG_PENDING
        # bundle index -> node_id bytes
        self.placements: Dict[int, bytes] = {}
        self.name = name
        self.label_selector = label_selector or {}

    def to_wire(self) -> dict:
        return {
            "pg_id": self.pg_id.binary(),
            "state": self.state,
            "strategy": self.strategy,
            "bundles": [b.to_wire() for b in self.bundles],
            "placements": {str(k): v for k, v in self.placements.items()},
            "name": self.name,
        }

    def to_persist(self) -> dict:
        return {**self.to_wire(), "labels": self.label_selector}

    @classmethod
    def from_persist(cls, d: dict) -> "PlacementGroupRecord":
        rec = cls(
            PlacementGroupID(d["pg_id"]),
            [pb.Bundle.from_wire(b) for b in d["bundles"]],
            d["strategy"], d["name"], label_selector=d.get("labels") or {},
        )
        rec.apply_update(d)
        return rec

    def apply_update(self, d: dict):
        self.state = d["state"]
        self.placements = {int(k): v for k, v in d["placements"].items()}


class ControlStore:
    """The cluster control plane service.

    With `control_store_persist` on, every table mutation is WAL-logged (and
    periodically snapshot-compacted) via persistence.WalStore; `start()`
    replays the log so a restarted control store resumes with nodes, actors,
    PGs, jobs, and KV intact (reference: gcs store_client persistence +
    GcsActorManager/GcsNodeManager restart recovery)."""

    def __init__(self, persist_dir: Optional[str] = None, epoch: int = 0):
        self.server = RpcServer(name="control_store")
        self.pubsub = PubSub(self.server)
        # structured cluster events (reference: the export-event pipeline —
        # export_*.proto schemas + dashboard/modules/aggregator/
        # aggregator_agent.py): bounded ring, queryable + pushed on the
        # "events" pubsub channel
        self.events: collections.deque = collections.deque(maxlen=10000)
        self._event_seq = 0
        # node_id bytes -> NodeInfo
        self.nodes: Dict[bytes, NodeInfo] = {}
        # node_id bytes -> (available ResourceSet, last heartbeat time)
        self.node_available: Dict[bytes, ResourceSet] = {}
        self.node_last_beat: Dict[bytes, float] = {}
        self.node_conns: Dict[bytes, int] = {}
        # daemon RPC clients per node
        self._daemon_clients: Dict[bytes, RpcClient] = {}
        self.kv: Dict[str, Dict[bytes, bytes]] = {}
        self.jobs: Dict[bytes, dict] = {}
        self._next_job = 1
        # submitted-job table (the job PLANE: ray_tpu_torch.job_submission
        # records, distinct from the internal driver-job table above) —
        # submission_id -> record. Persisted, so the table survives a
        # control-store kill+takeover and the JobManager actor recovers
        # all state from here (reference: the dashboard JobInfo storage
        # client keeping job records in the GCS KV).
        self.submitted_jobs: Dict[str, dict] = {}
        # pushed demand with expiry (elastic-train target width, external
        # reporters): key -> {"shapes": [wire], "expires": monotonic}.
        # Ephemeral by design — reporters refresh on their own cadence.
        self.reported_demand: Dict[str, dict] = {}
        # TTL'd preemption notices (the spot-survival plane): node_id ->
        # {"expires_ts": wall, "deadline_ts": wall}. PERSISTED (own WAL op
        # + snapshot field) unlike reported_demand: the PREEMPTING state and
        # its deadline must survive an HA failover — the new primary keeps
        # pre-provisioning replacement capacity for a node that is still
        # about to die. Expiry (reclaim cancelled, publisher gone) reverts
        # the node to ALIVE; publishers refresh on preempt_republish_period_s.
        self.preempt_notices: Dict[bytes, dict] = {}
        self.actors: Dict[bytes, ActorRecord] = {}
        self.named_actors: Dict[Tuple[str, str], bytes] = {}  # (namespace, name) -> actor_id
        self.placement_groups: Dict[bytes, PlacementGroupRecord] = {}
        # observability: bounded task-event history + per-reporter metric
        # accumulation (reference: GcsTaskManager, metrics agent). Reporters
        # are node daemons (pre-aggregated per node) or direct workers
        # (fallback); delta payloads accumulate into `acc`, legacy full
        # snapshots replace it. Drop accounting: trims here + drops the
        # reporters confessed to ride `task_events_dropped`.
        self.task_events: "collections.deque[dict]" = collections.deque()
        self.task_events_dropped = 0
        self.metrics_by_worker: Dict[bytes, dict] = {}
        # worker-process liveness records (reference: the GCS workers table
        # + worker-failure pubsub): live worker/driver RPC addresses with
        # their host node, plus a bounded set of authoritatively-dead
        # addresses. Borrow reapers consult these instead of trusting ping
        # timeouts (a stalled-but-alive borrower must keep its borrows).
        self.worker_addresses: Dict[str, str] = {}  # address -> node_id hex
        self.worker_addr_by_id: Dict[bytes, str] = {}
        # address -> {"ts", "reason", "exit_code"}: structured death records
        # so ObjectLostError/ActorDiedError can say WHY (preempted vs OOM vs
        # crash vs drained) instead of a generic "worker died"
        self.dead_worker_addresses: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict())
        # draining-node replica reports: node_id -> {oid_hex: location dict}.
        # Merged into the node's expected-death notice so owners fail over
        # to the replicas with ZERO lineage reconstructions.
        self.drained_replicas: Dict[bytes, dict] = {}
        # per-node scheduling load from heartbeats (autoscaler demand)
        self.node_load: Dict[bytes, dict] = {}
        # per-node physical stats from heartbeats (dashboard reporter)
        self.node_stats: Dict[bytes, dict] = {}
        # versioned node-table delta plane (the 1000-node fix): every node
        # mutation bumps `_node_version` and appends the published wire to a
        # bounded delta log, so subscribers reconcile from a cursor
        # (get_nodes_delta) instead of re-reading the full table — O(missed
        # changes), not O(nodes)
        self._node_version = 0
        self._node_deltas: collections.deque = collections.deque()
        # versioned worker-death delta plane (mirrors the node table): every
        # "workers"-channel notice is stamped with `_wv` and appended to a
        # bounded delta log, so subscribers that missed notices reconcile
        # from their cursor (get_workers_delta) — O(missed deaths), not a
        # full list_dead_workers snapshot per gap. Versions are PERSISTED
        # with each death record, so client cursors stay valid across a
        # store failover and the delta pull replays exactly what was missed.
        self._worker_version = 0
        self._worker_deltas: collections.deque = collections.deque()
        # availability-change log for heartbeat view deltas: the reply to a
        # cursor-carrying heartbeat lists only nodes whose availability (or
        # pending load) CHANGED since the daemon's cursor — the O(nodes)
        # view+nodes payload per beat was the dominant steady-state cost
        # at 1000 nodes (O(nodes^2) bytes per period cluster-wide)
        self._avail_version = 0
        self._avail_changes: collections.deque = collections.deque()
        self._avail_floor = 0  # oldest version the change log still covers
        # DEAD node records in death order: bounded by node_dead_retention
        # (evictions persist a tombstone) so node churn cannot grow the
        # table / WAL / snapshot / get_all_nodes payloads forever
        self._dead_order: collections.deque = collections.deque()
        self._health_task: Optional[asyncio.Task] = None
        self._stopped = False
        self._wal = None
        self._compacting = False
        self._recovered = False  # warm standby loads tables before start()
        self.epoch = epoch
        if persist_dir and GLOBAL_CONFIG.get("control_store_persist"):
            from ray_tpu_torch._private.persistence import WalStore

            self._wal = WalStore(
                persist_dir,
                compact_every=GLOBAL_CONFIG.get("control_store_wal_compact_every"),
                epoch=epoch,
            )

    # ------------------------------------------------------------------
    # persistence (reference: gcs/store_client/)
    # ------------------------------------------------------------------

    def _fenced(self, where: str):
        """A newer leader owns the persist dir: this process must stop
        serving NOW — acking one more mutation would split-brain the
        cluster's view of durable state."""
        flight_recorder.record("store", "fenced", where=where,
                               epoch=self.epoch)
        logger.critical(
            "control store FENCED (%s): epoch %d superseded by a newer "
            "leader; exiting", where, self.epoch)
        flight_recorder.crash_dump("store_fenced")
        os._exit(3)

    def _persist(self, op: str, data: dict):
        if self._wal is None:
            return
        try:
            due = self._wal.append({"op": op, "d": data})
        except FencedError:
            self._fenced(f"wal append {op}")
        if due and not self._compacting:
            # copy state + rotate synchronously (cheap, consistent with all
            # appends so far), then pack+fsync on a worker thread so the
            # event loop keeps serving heartbeats/leases during compaction
            self._compacting = True
            state = self._snapshot_state()
            self._wal.rotate()

            async def compact():
                try:
                    await asyncio.to_thread(self._wal.write_snapshot, state)
                except FencedError:
                    self._fenced("snapshot compaction")
                except Exception:  # noqa: BLE001 — wal.old survives; rotate() merges it
                    logger.exception("snapshot compaction failed; WAL retained")
                finally:
                    self._compacting = False

            spawn(compact())

    def _persist_actor(self, rec: ActorRecord):
        self._persist("actor_up", rec.to_wire())

    def _snapshot_state(self) -> dict:
        # Every container is freshly built (to_wire/to_persist allocate new
        # dicts; kv namespaces and job records are copied) because the pack +
        # fsync runs on a worker thread while the event loop keeps mutating
        # the live tables.
        return {
            "nodes": [n.to_wire() for n in self.nodes.values()],
            "node_version": self._node_version,
            "kv": {ns: dict(kvs) for ns, kvs in self.kv.items()},
            "jobs": [dict(j) for j in self.jobs.values()],
            "next_job": self._next_job,
            "submitted_jobs": [dict(j) for j in self.submitted_jobs.values()],
            "actors": [r.to_persist() for r in self.actors.values()],
            "pgs": [r.to_persist() for r in self.placement_groups.values()],
            # worker-death records + their delta-plane version: a failed-over
            # store resumes the same version counter, so subscriber cursors
            # stay valid and a post-failover reconcile replays exactly the
            # missed deaths instead of a full table
            "dead_workers": [
                {"address": addr, **rec}
                for addr, rec in self.dead_worker_addresses.items()
            ],
            "worker_version": self._worker_version,
            # wall-clock expiry/deadline stamps, so a failed-over store's
            # TTL sweep resumes where the old primary's left off
            "preempt_notices": [
                {"node_id": nid, **ent}
                for nid, ent in self.preempt_notices.items()
            ],
        }

    def _reset_tables(self):
        """Drop every persisted-state table (warm-standby re-seed from a
        fresh snapshot after the tail detected a compaction gap)."""
        self.nodes.clear()
        self.kv = {}
        self.jobs.clear()
        self.submitted_jobs.clear()
        self.actors.clear()
        self.named_actors.clear()
        self.placement_groups.clear()
        self.dead_worker_addresses.clear()
        self._node_deltas.clear()
        self._worker_deltas.clear()
        self.preempt_notices.clear()

    def _apply_snapshot(self, snap: dict):
        for nw in snap.get("nodes", []):
            info = NodeInfo.from_wire(nw)
            self.nodes[info.node_id.binary()] = info
        self._node_version = max(self._node_version,
                                 int(snap.get("node_version", 0) or 0))
        self.kv = {ns: dict(kvs) for ns, kvs in snap.get("kv", {}).items()}
        for job in snap.get("jobs", []):
            self.jobs[job["job_id"]] = job
        self._next_job = snap.get("next_job", self._next_job)
        for job in snap.get("submitted_jobs", []):
            self.submitted_jobs[job["submission_id"]] = job
        for aw in snap.get("actors", []):
            rec = ActorRecord.from_persist(aw)
            self.actors[rec.spec.actor_id.binary()] = rec
        for pw in snap.get("pgs", []):
            rec = PlacementGroupRecord.from_persist(pw)
            self.placement_groups[rec.pg_id.binary()] = rec
        for dw in snap.get("dead_workers", []):
            dw = dict(dw)
            addr = dw.pop("address", "")
            if addr:
                self.dead_worker_addresses[addr] = dw
        self._worker_version = max(self._worker_version,
                                   int(snap.get("worker_version", 0) or 0))
        for ent in snap.get("preempt_notices", []):
            ent = dict(ent)
            nid = ent.pop("node_id", b"")
            if nid:
                self.preempt_notices[nid] = ent

    def _apply_wal_record(self, rec: dict):
        op, d = rec["op"], rec["d"]
        if op == "node":
            info = NodeInfo.from_wire(d)
            self.nodes[info.node_id.binary()] = info
            ver = d.get("_v")
            if ver is not None and ver > self._node_version:
                # resume the delta-plane version counter AND rebuild the
                # recent-mutation log, so subscriber cursors from the old
                # incarnation stay valid after a failover
                self._node_version = ver
                self._node_deltas.append((ver, dict(d)))
                retention = GLOBAL_CONFIG.get("node_delta_retention")
                while len(self._node_deltas) > retention:
                    self._node_deltas.popleft()
        elif op == "kv_put":
            self.kv.setdefault(d["ns"], {})[d["key"]] = d["value"]
        elif op == "kv_del":
            self.kv.get(d["ns"], {}).pop(d["key"], None)
        elif op == "job":
            self.jobs[d["job"]["job_id"]] = d["job"]
            if "next_job" in d:
                self._next_job = d["next_job"]
        elif op == "subjob":
            # full-record upsert: submitted-job records are small (the
            # working-dir payload never enters the store)
            self.submitted_jobs[d["submission_id"]] = d
        elif op == "actor":
            arec = ActorRecord.from_persist(d)
            self.actors[arec.spec.actor_id.binary()] = arec
        elif op == "actor_up":
            arec = self.actors.get(d["actor_id"])
            if arec is not None:
                arec.apply_update(d)
        elif op == "pg":
            prec = PlacementGroupRecord.from_persist(d)
            self.placement_groups[prec.pg_id.binary()] = prec
        elif op == "pg_up":
            prec = self.placement_groups.get(d["pg_id"])
            if prec is not None:
                prec.apply_update(d)
        elif op == "node_del":
            # dead-node retention tombstone: the record was pruned while
            # this WAL segment was live — don't resurrect it
            self.nodes.pop(d["node_id"], None)
        elif op == "preempt":
            d = dict(d)
            nid = d.pop("node_id", b"")
            if nid:
                self.preempt_notices[nid] = d
        elif op == "preempt_del":
            self.preempt_notices.pop(d["node_id"], None)
        elif op == "worker_dead":
            d = dict(d)
            addr = d.pop("address", "")
            if addr:
                self.dead_worker_addresses[addr] = d
                self.dead_worker_addresses.move_to_end(addr)
                wv = d.get("_wv")
                if wv is not None and wv > self._worker_version:
                    self._worker_version = wv
                    self._worker_deltas.append((wv, {
                        "address": addr, "dead": True,
                        "reason": d.get("reason", ""),
                        "exit_code": d.get("exit_code"), "_wv": wv,
                    }))
                    retention = GLOBAL_CONFIG.get("node_delta_retention")
                    while len(self._worker_deltas) > retention:
                        self._worker_deltas.popleft()
        elif op == "worker_live":
            # a recycled address re-registered: its death record is stale —
            # drop it from the table AND the rebuilt delta log (a cursor
            # replay must not reap the live process's borrows), and resume
            # the version line the live delta advanced
            addr = d.get("address", "")
            self.dead_worker_addresses.pop(addr, None)
            if any(w.get("address") == addr for _, w in self._worker_deltas):
                self._worker_deltas = collections.deque(
                    (v, w) for v, w in self._worker_deltas
                    if w.get("address") != addr)
            wv = d.get("_wv")
            if wv is not None and wv > self._worker_version:
                self._worker_version = wv
                self._worker_deltas.append(
                    (wv, {"address": addr, "dead": False, "_wv": wv}))

    def _recover(self):
        snap, wal_records = self._wal.recover()
        if snap:
            self._apply_snapshot(snap)
        for rec in wal_records:
            try:
                self._apply_wal_record(rec)
            except Exception:  # noqa: BLE001 — skip bad record, keep the rest
                logger.exception("skipping bad WAL record")
        if not snap and not wal_records:
            return
        self._activate_recovered()

    def _activate_recovered(self):
        """Post-recovery activation (leader side only, after the tables are
        loaded — from recover() or a warm-standby tail): heartbeat grace,
        retention-order/name-index rebuilds, and re-spawning the async work
        (actor creations, PG scheduling) that was in flight when the
        previous incumbent died."""
        now = time.monotonic()
        for nid, info in self.nodes.items():
            if info.state in (pb.NODE_ALIVE, pb.NODE_PREEMPTING):
                # grace period: the daemon re-heartbeats (and re-registers on
                # the "unknown" reply) or the health loop declares it dead.
                # PREEMPTING nodes are still live (their drain hasn't
                # started) — without the grace they would linger unwatched.
                self.node_last_beat[nid] = now
                self.node_available[nid] = info.resources
                self._bump_avail(nid)
        # rebuild the dead-node retention order (death-ts order) so churn
        # pruning keeps working across a restart
        self._dead_order.extend(sorted(
            (nid for nid, info in self.nodes.items()
             if info.state == pb.NODE_DEAD),
            key=lambda nid: (self.nodes[nid].death.ts
                             if self.nodes[nid].death else 0.0),
        ))
        for aid, rec in self.actors.items():
            if rec.name:
                self.named_actors[(rec.spec.runtime_env.get("namespace", ""), rec.name)] = aid
            if rec.state in (pb.ACTOR_PENDING, pb.ACTOR_RESTARTING):
                # creation was in flight when we died: restart it
                rec.pending_create = spawn(self._create_actor(rec))
        for pg in self.placement_groups.values():
            if pg.state == pb.PG_PENDING:
                spawn(self._schedule_pg(pg))
        logger.info(
            "recovered control-store state: %d nodes, %d actors, %d PGs, "
            "%d jobs", len(self.nodes), len(self.actors),
            len(self.placement_groups), len(self.jobs),
        )

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        if self._wal is not None and not self._recovered:
            self._recover()
        self._recovered = True
        self.server.register_service(self)
        self.server.on_disconnect(self._on_disconnect)
        addr = await self.server.start(host, port)
        self._health_task = spawn(self._health_loop())
        logger.info("control store listening on %s", addr)
        return addr

    async def stop(self):
        self._stopped = True
        if self._health_task:
            self._health_task.cancel()
        for c in self._daemon_clients.values():
            await c.close()
        await self.server.stop()

    def _on_disconnect(self, conn_id: int) -> None:
        self.pubsub.unsubscribe_conn(conn_id)

    # ------------------------------------------------------------------
    # versioned node-table deltas (scale plane)
    # ------------------------------------------------------------------

    def _record_node_delta(self, info: NodeInfo) -> dict:
        """Stamp a node mutation into the bounded delta log; returns the
        wire dict (carrying `_v`) that both the pubsub notice and any
        cursor reconcile will see — one ordered history, two transports."""
        self._node_version += 1
        wire = info.to_wire()
        wire["_v"] = self._node_version
        self._node_deltas.append((self._node_version, wire))
        retention = GLOBAL_CONFIG.get("node_delta_retention")
        while len(self._node_deltas) > retention:
            self._node_deltas.popleft()
        return wire

    def _bump_avail(self, node_id: bytes) -> None:
        self._avail_version += 1
        self._avail_changes.append((self._avail_version, node_id))
        retention = GLOBAL_CONFIG.get("node_delta_retention")
        while len(self._avail_changes) > retention:
            ver, _ = self._avail_changes.popleft()
            self._avail_floor = ver

    def _view_reply(self, cursor: int) -> dict:
        """Availability view since `cursor` (the daemon's last-seen
        `view_version`): changed entries + removals, or one full snapshot
        when the cursor predates the change log."""
        reply: dict = {
            "view_version": self._avail_version,
            "nodes_version": self._node_version,
        }
        changed = self._changed_nodes_since(cursor)
        if changed is None:
            reply["view_full"] = {
                self.nodes[n].node_id.hex(): a.to_wire()
                for n, a in self.node_available.items()
                if n in self.nodes and self.nodes[n].state == pb.NODE_ALIVE
            }
            return reply
        delta: Dict[str, dict] = {}
        removed: List[str] = []
        for nid in changed:
            info = self.nodes.get(nid)
            avail = self.node_available.get(nid)
            if info is None or info.state != pb.NODE_ALIVE or avail is None:
                removed.append(nid.hex())
            else:
                delta[info.node_id.hex()] = avail.to_wire()
        if delta:
            reply["view_delta"] = delta
        if removed:
            reply["view_removed"] = removed
        return reply

    def _changed_nodes_since(self, cursor: int) -> Optional[Set[bytes]]:
        """Node ids whose availability/load changed since `cursor`, scanned
        newest-first so the cost is O(changes since cursor), not O(log).
        None = the cursor predates the change log — or postdates our
        counter (restarted store) — so the caller must send full."""
        if (cursor < self._avail_floor or cursor < 0
                or cursor > self._avail_version):
            return None
        changed: Set[bytes] = set()
        for ver, nid in reversed(self._avail_changes):
            if ver <= cursor:
                break
            changed.add(nid)
        return changed

    def _prune_dead_nodes(self) -> None:
        retention = GLOBAL_CONFIG.get("node_dead_retention")
        while len(self._dead_order) > retention:
            old = self._dead_order.popleft()
            info = self.nodes.get(old)
            if info is None or info.state != pb.NODE_DEAD:
                continue
            self.nodes.pop(old, None)
            self.node_last_beat.pop(old, None)
            self.drained_replicas.pop(old, None)
            # tombstone so a recovered store doesn't resurrect the record
            # from an earlier WAL "node" entry
            self._persist("node_del", {"node_id": old})

    async def _daemon(self, node_id: bytes) -> RpcClient:
        client = self._daemon_clients.get(node_id)
        if client is None:
            info = self.nodes[node_id]
            client = RpcClient(info.address, name=f"cs->daemon-{info.node_id.hex()[:6]}")
            await client.connect()
            self._daemon_clients[node_id] = client
        return client

    # ------------------------------------------------------------------
    # health checking (reference: gcs_health_check_manager.h)
    # ------------------------------------------------------------------

    async def _health_loop(self):
        period = GLOBAL_CONFIG.get("health_check_period_s")
        timeout = GLOBAL_CONFIG.get("health_check_timeout_s")
        shard = 0
        while not self._stopped:
            # sharded scan: large clusters split the liveness sweep across
            # the period (one shard per tick) so expiry processing — death
            # marking, pubsub fanout, actor failover — never lands as one
            # 1000-node burst on a single event-loop tick. Each node is
            # still visited about once per period.
            nshards = max(1, min(8, (len(self.node_last_beat) + 127) // 128))
            await asyncio.sleep(period / nshards)
            shard = (shard + 1) % nshards
            self._sweep_preempt_notices()
            now = time.monotonic()
            for node_id, last in list(self.node_last_beat.items()):
                if nshards > 1 and node_id and node_id[0] % nshards != shard:
                    continue
                info = self.nodes.get(node_id)
                if info is None or info.state == pb.NODE_DEAD:
                    continue
                if now - last > timeout:
                    await self._mark_node_dead(node_id, "health check timed out")

    def _sweep_preempt_notices(self) -> None:
        """Expire aged-out preemption notices: a PREEMPTING node whose
        notice TTL lapsed without a drain or death (the reclaim was
        cancelled, or the publisher died silently) returns to ALIVE and
        stops counting as proactive demand. Live publishers refresh on
        preempt_republish_period_s, so only an abandoned notice ages out."""
        now = time.time()
        for nid in [n for n, ent in self.preempt_notices.items()
                    if ent["expires_ts"] < now]:
            self.preempt_notices.pop(nid, None)
            self._persist("preempt_del", {"node_id": nid})
            info = self.nodes.get(nid)
            if info is None or info.state != pb.NODE_PREEMPTING:
                continue  # drain/death already superseded the notice
            flight_recorder.record("node", "preempt_expired",
                                   node=info.node_id.hex()[:12])
            info.state = pb.NODE_ALIVE
            info.drain_reason = ""
            info.drain_deadline = 0.0
            self._event("node", "ALIVE", "preemption notice expired",
                        node_id=info.node_id.hex())
            self._bump_avail(nid)
            wire = self._record_node_delta(info)
            self._persist("node", wire)
            self.pubsub.publish("nodes", wire)

    async def _mark_node_dead(self, node_id: bytes, reason: str,
                              expected: bool = False):
        info = self.nodes.get(node_id)
        if info is None or info.state == pb.NODE_DEAD:
            return
        flight_recorder.record("node", "dead", node=info.node_id.hex()[:12],
                               reason=reason, expected=expected)
        info.state = pb.NODE_DEAD
        # planned vs unexpected termination recorded in the node table
        # (reference: NodeDeathInfo) — owners choose replica failover vs
        # lineage reconstruction off this bit
        info.death = pb.NodeDeathInfo(expected=expected, reason=reason,
                                      ts=time.time())
        self.node_available.pop(node_id, None)
        self.node_load.pop(node_id, None)
        self.node_stats.pop(node_id, None)  # never serve a dead node's stats
        if self.preempt_notices.pop(node_id, None) is not None:
            self._persist("preempt_del", {"node_id": node_id})
        client = self._daemon_clients.pop(node_id, None)
        if client:
            await client.close()
        log = logger.info if expected else logger.warning
        log("node %s marked DEAD (%s): %s", info.node_id.hex()[:8],
            "expected" if expected else "unexpected", reason)
        # every worker/driver process registered on the node died with it:
        # record their addresses so borrow reapers can reconcile
        node_hex = info.node_id.hex()
        for addr, nhex in list(self.worker_addresses.items()):
            if nhex == node_hex:
                self.worker_addresses.pop(addr, None)
                self._mark_worker_dead(addr, reason=f"node died: {reason}")
        self._event("node", "DEAD", reason, node_id=info.node_id.hex(),
                    expected=expected)
        self._bump_avail(node_id)  # cursor readers see the removal
        notice = self._record_node_delta(info)
        # persist the _v-stamped wire: a failed-over store resumes the same
        # delta-plane version counter, keeping subscriber cursors valid
        self._persist("node", notice)
        replicas = self.drained_replicas.get(node_id)
        if expected and replicas:
            # expected death with pre-replicated primaries: the notice tells
            # owners exactly where each copy went, so readers fail over with
            # zero reconstructions (the delta-log entry carries them too —
            # a cursor reconcile must see the same story as the stream)
            notice["replicas"] = replicas
        self._dead_order.append(node_id)
        self._prune_dead_nodes()
        self.pubsub.publish("nodes", notice)
        # Fail over actors that lived on the node. An EXPECTED death should
        # find none (drain migrated them) — any straggler restarts without
        # charging its max_restarts budget (planned removal must be cheap).
        for rec in list(self.actors.values()):
            if rec.node_id == node_id and rec.state in (pb.ACTOR_ALIVE, pb.ACTOR_PENDING):
                await self._on_actor_worker_death(
                    rec, f"node died: {reason}", planned=expected)
        # Reschedule placement groups with bundles on the dead node: return
        # surviving bundles, reset to PENDING, and re-run placement
        # (reference: gcs_placement_group_manager.h node-death rescheduling).
        for pg in list(self.placement_groups.values()):
            if pg.state == pb.PG_CREATED and node_id in set(pg.placements.values()):
                for nid in set(pg.placements.values()) - {node_id}:
                    try:
                        daemon = await self._daemon(nid)
                        await daemon.call(
                            "return_bundles", {"pg_id": pg.pg_id.binary()}, timeout=5
                        )
                    except Exception:  # noqa: BLE001 — node may be going too
                        pass
                pg.placements = {}
                pg.state = pb.PG_PENDING
                self.pubsub.publish("placement_groups", pg.to_wire())
                spawn(self._schedule_pg(pg))

    # ------------------------------------------------------------------
    # node service (reference: gcs_service.proto NodeInfo :771)
    # ------------------------------------------------------------------

    async def rpc_register_node(self, conn_id: int, payload: dict) -> dict:
        info = NodeInfo.from_wire(payload["node"])
        flight_recorder.record("node", "register",
                               node=info.node_id.hex()[:12],
                               address=info.address)
        self.nodes[info.node_id.binary()] = info
        self.node_available[info.node_id.binary()] = info.resources
        self.node_last_beat[info.node_id.binary()] = time.monotonic()
        self.node_conns[info.node_id.binary()] = conn_id
        logger.info(
            "node %s registered at %s resources=%s",
            info.node_id.hex()[:8], info.address, info.resources.to_dict(),
        )
        self._event("node", "REGISTERED", info.address,
                    node_id=info.node_id.hex(),
                    resources=info.resources.to_dict())
        self._bump_avail(info.node_id.binary())
        wire = self._record_node_delta(info)
        self._persist("node", wire)
        self.pubsub.publish("nodes", wire)
        if payload.get("lean"):
            # scale mode: the joiner pulls the membership snapshot once via
            # get_nodes_delta(cursor=-1) instead of every register reply
            # shipping the full table — a 1000-node register storm would
            # otherwise serialize O(nodes^2) wires here
            return {"ok": True, "version": self._node_version}
        # seed the joiner with the existing membership (it only receives
        # pushes for changes after its subscription)
        return {
            "ok": True,
            "version": self._node_version,
            "nodes": [
                n.to_wire() for n in self.nodes.values()
                if n.state == pb.NODE_ALIVE
            ],
        }

    async def rpc_heartbeat(self, conn_id: int, payload: dict) -> dict:
        node_id = payload["node_id"]
        if node_id not in self.nodes or self.nodes[node_id].state == pb.NODE_DEAD:
            # no record (restarted / unpersisted control store) or declared
            # dead during a partition: tell the daemon to re-register
            # (node_daemon._heartbeat_loop reacts to this key)
            return {"unknown": True}
        self.node_last_beat[node_id] = time.monotonic()
        if "available" in payload:
            new_avail = ResourceSet.from_wire(payload["available"])
            old_avail = self.node_available.get(node_id)
            if old_avail is None or old_avail.to_wire() != new_avail.to_wire():
                self._bump_avail(node_id)
            self.node_available[node_id] = new_avail
        if "stats" in payload:
            # per-node psutil/store snapshot for the dashboard (reference:
            # the reporter agent publishing node physical stats)
            self.node_stats[node_id] = {
                **payload["stats"], "ts": time.time(),
            }
        # demand signal for the autoscaler (reference: raylets report load in
        # resource-view sync; GcsAutoscalerStateManager aggregates it)
        old_load = self.node_load.get(node_id)
        new_pending = payload.get("pending", 0)
        if old_load is None or old_load.get("pending") != new_pending:
            # pending-load changes version the node for cursor readers too
            # (the autoscaler's idle/demand rows key off pending + avail)
            self._bump_avail(node_id)
        self.node_load[node_id] = {
            "pending": new_pending,
            "pending_resources": payload.get("pending_resources", []),
            "ts": time.monotonic(),
        }
        cursor = payload.get("view_cursor")
        if cursor is not None and GLOBAL_CONFIG.get("node_table_delta_sync"):
            # scale mode: the reply carries only availability CHANGES since
            # the daemon's cursor (plus the node-table version so the daemon
            # knows when to pull membership deltas) — the full O(nodes)
            # view+nodes payload per beat is what melts at 1000 nodes
            return self._view_reply(int(cursor))
        # Reply carries the cluster resource view — the gossip function of
        # ray_syncer (src/ray/ray_syncer/ray_syncer.h:91) piggybacked on the
        # health-check beat.
        return {
            "view": {
                nid.hex() if isinstance(nid, bytes) else nid: avail.to_wire()
                for nid, avail in (
                    (self.nodes[n].node_id.binary(), a)
                    for n, a in self.node_available.items()
                    if n in self.nodes and self.nodes[n].state == pb.NODE_ALIVE
                )
            },
            "nodes": [
                self.nodes[n].to_wire()
                for n in self.node_available
                if n in self.nodes
            ],
        }

    async def rpc_get_cluster_load(self, conn_id: int, payload) -> dict:
        """Aggregate demand + per-node idleness for the autoscaler
        (reference: AutoscalerStateService GetClusterResourceState,
        autoscaler.proto:413)."""
        # cursor readers (the autoscaler's poll) get rows only for nodes
        # whose availability/load changed since their last poll + a removed
        # list, instead of the full O(nodes) row set every tick; aggregate
        # demand (small) is always fresh
        cursor = (payload or {}).get("cursor") if isinstance(payload, dict) \
            else None
        changed: Optional[Set[bytes]] = None
        removed: List[str] = []
        if cursor is not None and GLOBAL_CONFIG.get("node_table_delta_sync"):
            changed = self._changed_nodes_since(int(cursor))
            if changed is not None:
                removed = [
                    nid.hex() for nid in changed
                    if (self.nodes.get(nid) is None
                        or self.nodes[nid].state not in (pb.NODE_ALIVE,
                                                         pb.NODE_DRAINING,
                                                         pb.NODE_PREEMPTING))
                ]
        nodes = []
        pending_total = 0
        pending_resources: List[dict] = []
        for nid, info in self.nodes.items():
            if info.state not in (pb.NODE_ALIVE, pb.NODE_DRAINING,
                                  pb.NODE_PREEMPTING):
                continue
            load = self.node_load.get(nid, {})
            avail = self.node_available.get(nid)
            pending_total += load.get("pending", 0)
            pending_resources.extend(load.get("pending_resources", []))
            if changed is not None and nid not in changed:
                continue
            nodes.append({
                "node_id": info.node_id.hex(),
                "state": info.state,
                "total": info.resources.to_wire(),
                "available": avail.to_wire() if avail else {},
                "pending": load.get("pending", 0),
                # the autoscaler matches a cloud machine's daemon by label
                "labels": dict(info.labels),
                "idle": (avail is not None
                         and avail.to_wire() == info.resources.to_wire()
                         and load.get("pending", 0) == 0),
            })
        # PENDING placement groups are demand too — their bundles (e.g. the
        # TPU-{type}-head slice reservations) are what drives slice-aware
        # scale-up (reference: GetClusterResourceState includes pending
        # gang resource requests)
        pending_pg_bundles: List[dict] = []
        for rec in self.placement_groups.values():
            if rec.state != pb.PG_PENDING:
                continue
            for b in rec.bundles:
                pending_pg_bundles.append({
                    "resources": b.resources.to_wire(),
                    "strategy": rec.strategy,
                    "labels": dict(rec.label_selector or {}),
                })
        # queued-job demand: jobs admitted-or-waiting in the submitted-job
        # table that have not started running yet produce NO lease demand
        # (their drivers don't exist) — the demand-driven autoscaler sees
        # them here instead of waiting for admission + lease pending +
        # heartbeat (the liveness-reactive pipeline)
        pending_job_resources: List[dict] = []
        pending_jobs_total = 0
        shapes_cap = GLOBAL_CONFIG.get("autoscaler_job_shapes_max")
        for j in self.submitted_jobs.values():
            if j.get("status") not in ("QUEUED", "PENDING"):
                continue
            pending_jobs_total += 1
            if len(pending_job_resources) < shapes_cap:
                # job records hold human-unit floats; demand shapes travel
                # in wire (fixed-point) format like heartbeat lease shapes
                pending_job_resources.append(ResourceSet(
                    dict(j.get("resources") or {"CPU": 1.0})).to_wire())
        # pushed demand (elastic-train target width, external reporters),
        # swept lazily on read
        now_m = time.monotonic()
        reported: List[dict] = []
        for key in list(self.reported_demand):
            ent = self.reported_demand[key]
            if ent["expires"] < now_m:
                del self.reported_demand[key]
                continue
            reported.extend(ent["shapes"])
        # PREEMPTING nodes' COMMITTED load (total - available: running
        # leases, actor/PG reservations, serve replicas, elastic ranks) is
        # demand the proactive reconciler must re-home NOW — the node dies
        # at its deadline whether or not a replacement exists (always in
        # the reply; the A/B lever lives in the autoscaler, not here)
        preempting: List[dict] = []
        for nid, ent in self.preempt_notices.items():
            info = self.nodes.get(nid)
            if info is None or info.state != pb.NODE_PREEMPTING:
                continue
            avail = self.node_available.get(nid)
            committed = (info.resources - avail) if avail is not None \
                else info.resources
            preempting.append({
                "node_id": info.node_id.hex(),
                "deadline_ts": ent.get("deadline_ts", 0.0),
                "committed": committed.to_wire(),
                "total": info.resources.to_wire(),
            })
        reply = {
            "pending_total": pending_total,
            "pending_resources": pending_resources,
            "pending_pg_bundles": pending_pg_bundles,
            "pending_job_resources": pending_job_resources,
            "pending_jobs_total": pending_jobs_total,
            "reported_demand": reported,
            "preempting": preempting,
            "nodes": nodes,
            "version": self._avail_version,
        }
        if changed is not None:
            reply["delta"] = True
            reply["removed"] = removed
        return reply

    async def rpc_get_resource_view(self, conn_id: int, payload) -> dict:
        return {
            "view": {
                self.nodes[n].node_id.hex(): a.to_wire()
                for n, a in self.node_available.items()
                if n in self.nodes and self.nodes[n].state == pb.NODE_ALIVE
            }
        }

    def _node_wires(self) -> List[dict]:
        # expectedly-dead drained nodes carry their replica map so a gap
        # reconcile (missed death notice during failover) still fails
        # readers over instead of reconstructing
        out = []
        for nid, n in self.nodes.items():
            wire = n.to_wire()
            reps = self.drained_replicas.get(nid)
            if reps and n.state == pb.NODE_DEAD and n.death and n.death.expected:
                wire["replicas"] = reps
            out.append(wire)
        return out

    async def rpc_get_all_nodes(self, conn_id: int, payload) -> dict:
        out = self._node_wires()
        reply: dict = {"version": self._node_version, "total": len(out)}
        limit = (payload or {}).get("limit")
        if limit is not None:
            # paginated read (dashboard at 1000 nodes): one page per call
            # instead of the whole table serialized per poll
            offset = max(0, int((payload or {}).get("offset", 0)))
            out = out[offset:offset + max(0, int(limit))]
            reply["offset"] = offset
        reply["nodes"] = out
        return reply

    async def rpc_get_nodes_delta(self, conn_id: int, payload) -> dict:
        """Cursor reconcile for node-table subscribers: every mutation since
        `cursor` in publish order, or one full snapshot when the cursor
        predates the bounded delta log (retention: node_delta_retention).
        The wires are the SAME dicts the "nodes" pubsub published (incl.
        `_v` and expected-death replica maps) — a subscriber that missed
        notices replays exactly what it missed."""
        cursor = int((payload or {}).get("cursor", -1))
        if cursor == self._node_version:
            return {"version": self._node_version, "updates": []}
        if (cursor < 0 or cursor > self._node_version
                or not self._node_deltas
                or cursor < self._node_deltas[0][0] - 1):
            # cursor predates the retained log — or POSTDATES our counter
            # (this store restarted and reset its versions; the client's
            # cursor is from a previous incarnation): full snapshot either
            # way, and the client RESETS its cursor to our version
            return {"version": self._node_version, "full": True,
                    "nodes": self._node_wires()}
        return {
            "version": self._node_version,
            "updates": [w for ver, w in self._node_deltas if ver > cursor],
        }

    async def rpc_get_node_stats(self, conn_id: int, payload) -> dict:
        """Per-node physical stats from heartbeats (reference: the reporter
        agent's psutil samples surfaced via the dashboard head)."""
        return {"stats": {
            nid.hex(): stats for nid, stats in self.node_stats.items()
        }}

    async def rpc_report_preemption_notice(self, conn_id: int,
                                           payload: dict) -> dict:
        """A node learned it is about to be reclaimed (GCE maintenance
        event / spot preemption): record a TTL'd notice and move the node
        to PREEMPTING — visible on the "nodes" channel, in get_nodes_delta,
        and as committed-load demand in get_cluster_load, so the proactive
        reconciler pre-provisions replacement capacity BEFORE the drain
        consumes the warning window. Idempotent: re-publication (the
        daemon's refresh cadence, or a re-publish after a store failover)
        refreshes the TTL without minting a new delta. The state is
        persisted + delta-versioned like every node mutation, so it
        survives an HA failover."""
        node_id = payload["node_id"]
        info = self.nodes.get(node_id)
        if info is None or info.state == pb.NODE_DEAD:
            return {"ok": False, "error": "unknown or dead node"}
        if info.state == pb.NODE_DRAINING:
            # the drain already started (reconciler or deadline got there
            # first): the notice is moot, don't regress the state machine
            return {"ok": True, "state": info.state}
        deadline_s = float(payload.get("deadline_s")
                           or GLOBAL_CONFIG.get("drain_deadline_s"))
        ttl = float(payload.get("ttl_s")
                    or GLOBAL_CONFIG.get("preempt_notice_ttl_s"))
        now = time.time()
        prior = self.preempt_notices.get(node_id)
        ent = {
            # a refresh never EXTENDS the death deadline: the host dies at
            # the first notice's wall-clock time regardless of re-publishes
            "deadline_ts": min(prior["deadline_ts"], now + deadline_s)
            if prior else now + deadline_s,
            "expires_ts": now + ttl,
        }
        self.preempt_notices[node_id] = ent
        self._persist("preempt", {"node_id": node_id, **ent})
        if info.state != pb.NODE_PREEMPTING:
            flight_recorder.record(
                "node", "preempting", node=info.node_id.hex()[:12],
                deadline_s=deadline_s)
            info.state = pb.NODE_PREEMPTING
            info.drain_reason = pb.DRAIN_REASON_PREEMPTION
            info.drain_deadline = ent["deadline_ts"]
            self._event("node", "PREEMPTING", "preemption notice",
                        node_id=info.node_id.hex(), deadline_s=deadline_s)
            self._bump_avail(node_id)  # leaves new-placement views
            wire = self._record_node_delta(info)
            self._persist("node", wire)
            self.pubsub.publish("nodes", wire)
        return {"ok": True, "state": info.state,
                "deadline_ts": ent["deadline_ts"]}

    async def rpc_drain_node(self, conn_id: int, payload: dict) -> dict:
        """DrainNode: planned removal with `{reason, deadline_s}` (reference:
        node_manager.proto DrainNode + autoscaler.proto DrainNodeReason).
        The notice goes out on the "nodes" channel; the daemon mirrors the
        state into its lease gate and — when a deadline is present — runs
        the full drain orchestration (finish work, replicate primaries,
        exit expected). Actors on the node migrate immediately without
        charging their restart budget."""
        node_id = payload["node_id"]
        info = self.nodes.get(node_id)
        if info is None or info.state == pb.NODE_DEAD:
            return {"ok": False}
        reason = payload.get("reason") or pb.DRAIN_REASON_MANUAL
        deadline_s = float(payload.get("deadline_s") or 0.0)
        flight_recorder.record("node", "drain", node=info.node_id.hex()[:12],
                               reason=reason, deadline_s=deadline_s)
        if self.preempt_notices.pop(node_id, None) is not None:
            # the drain supersedes the PREEMPTING phase; drop the notice so
            # its TTL expiry can't revive a node mid-exit-orchestration
            self._persist("preempt_del", {"node_id": node_id})
        info.state = pb.NODE_DRAINING
        info.drain_reason = reason
        info.drain_deadline = time.time() + deadline_s if deadline_s else 0.0
        self._event("node", "DRAINING", f"drain requested ({reason})",
                    node_id=info.node_id.hex(), reason=reason,
                    deadline_s=deadline_s)
        self._bump_avail(node_id)  # draining nodes leave the scheduling view
        wire = self._record_node_delta(info)
        self._persist("node", wire)
        self.pubsub.publish("nodes", wire)
        if deadline_s:
            # terminal drain (preemption/manual removal): migrate resident
            # actors NOW so they restart warm elsewhere instead of crash-
            # recovering when the node exits. Reversible idle-drains (no
            # deadline) leave actors alone — there should be none anyway.
            spawn(self._migrate_actors_off(node_id, reason))
        return {"ok": True}

    async def _migrate_actors_off(self, node_id: bytes, reason: str):
        """Planned actor migration off a draining node (reference: the
        checkpoint-or-migrate half of graceful drain): each ALIVE actor is
        killed on the draining node and recreated elsewhere as a PLANNED
        restart — incarnation advances (ordering semantics stay crash-
        equivalent) but max_restarts is not charged. PG-bound actors stay:
        their bundle lives on this node until node death reschedules the
        whole group."""
        for rec in list(self.actors.values()):
            if rec.node_id != node_id or rec.state != pb.ACTOR_ALIVE:
                continue
            if rec.spec.strategy.kind == pb.STRATEGY_PLACEMENT_GROUP:
                continue
            if rec.spec.drain_cooperative:
                # the owner coordinates this actor's planned removal (the
                # elastic train controller live-shrinks its gang inside
                # the drain window and releases the doomed ranks itself);
                # killing it here would destroy the state the owner is
                # about to move
                continue
            cause = f"node draining ({reason})"
            if rec.node_id is not None and rec.worker_id:
                try:
                    daemon = await self._daemon(rec.node_id)
                    await daemon.call(
                        "kill_worker",
                        {"worker_id": rec.worker_id, "reason": cause},
                        timeout=5,
                    )
                except Exception:  # noqa: BLE001 — node may be going already
                    pass
            # restartable actors migrate (planned restart, budget untouched);
            # max_restarts=0 actors die NOW with a cause naming the drain so
            # their owner rebuilds during the warning window instead of at
            # the node's hard death
            await self._on_actor_worker_death(rec, cause, planned=True)

    async def rpc_report_drain_replicas(self, conn_id: int, payload: dict) -> dict:
        """A draining daemon replicated its primary copies to live peers;
        remember where each went so the expected-death notice (and gap-
        reconcile reads) can point owners at the replicas."""
        node_id = payload["node_id"]
        reps = self.drained_replicas.setdefault(node_id, {})
        reps.update(payload.get("replicas") or {})
        # bounded: one entry per draining node, pruned with the node record
        while len(self.drained_replicas) > 64:
            self.drained_replicas.pop(next(iter(self.drained_replicas)))
        return {"ok": True, "count": len(reps)}

    async def rpc_undrain_node(self, conn_id: int, payload: dict) -> dict:
        """Reverse a drain that never reached termination — demand returned
        before the autoscaler terminated the node (reference: autoscaler v2
        cancels drains for nodes it decides to keep)."""
        node_id = payload["node_id"]
        info = self.nodes.get(node_id)
        if info is None or info.state != pb.NODE_DRAINING:
            return {"ok": False}
        if info.drain_deadline:
            # deadline drains are TERMINAL: the daemon is already running
            # its exit orchestration and cannot be called back — reviving
            # the record would route fresh leases onto a node about to die
            # and drop its replica map
            return {"ok": False, "error": "drain is terminal (deadline set)"}
        info.state = pb.NODE_ALIVE
        info.drain_reason = ""
        info.drain_deadline = 0.0
        self.drained_replicas.pop(node_id, None)
        self._bump_avail(node_id)
        wire = self._record_node_delta(info)
        self._persist("node", wire)
        self.pubsub.publish("nodes", wire)
        return {"ok": True}

    async def rpc_unregister_node(self, conn_id: int, payload: dict) -> dict:
        """Administrative removal: an expected termination unless the
        caller says otherwise (a drained daemon unregisters itself on exit
        with the drain reason so the death record says WHY)."""
        await self._mark_node_dead(
            payload["node_id"],
            payload.get("reason", "unregistered"),
            expected=payload.get("expected", True),
        )
        return {"ok": True}

    # ------------------------------------------------------------------
    # worker liveness records (reference: the GCS workers table + worker-
    # failure pubsub — reference_counter's borrower cleanup keys off these
    # authoritative notices, never off ping timeouts)
    # ------------------------------------------------------------------

    def _record_worker_delta(self, notice: dict) -> dict:
        """Stamp a workers-channel mutation into the bounded delta log;
        returns the wire dict (carrying `_wv`) that both the pubsub notice
        and any cursor reconcile will see — one ordered history, two
        transports (the node table's `_record_node_delta`, mirrored)."""
        self._worker_version += 1
        wire = {**notice, "_wv": self._worker_version}
        self._worker_deltas.append((self._worker_version, wire))
        retention = GLOBAL_CONFIG.get("node_delta_retention")
        while len(self._worker_deltas) > retention:
            self._worker_deltas.popleft()
        return wire

    def _mark_worker_dead(self, address: str, reason: str = "",
                          exit_code: Optional[int] = None):
        if address in self.dead_worker_addresses:
            # idempotent: a retried report (lost reply, failover replay)
            # must not mint a SECOND death with a fresh _wv — subscribers
            # would apply it twice, breaking the zero-dup guarantee. A
            # legitimate re-death is preceded by a re-registration, which
            # durably clears the record (worker_live).
            return
        flight_recorder.record("worker", "dead", address=address,
                               reason=reason, exit_code=exit_code)
        notice = self._record_worker_delta({
            "address": address, "dead": True,
            "reason": reason, "exit_code": exit_code,
        })
        self.dead_worker_addresses[address] = {
            "ts": time.time(), "reason": reason, "exit_code": exit_code,
            "_wv": notice["_wv"],
        }
        self.dead_worker_addresses.move_to_end(address)
        while len(self.dead_worker_addresses) > 65536:
            self.dead_worker_addresses.popitem(last=False)
        # the death record must survive a failover: a standby that never
        # heard this notice still has to answer the cursor reconciles that
        # replay it (zero-loss resubscribe is only as strong as the
        # durability of what is being resubscribed to)
        self._persist("worker_dead", {
            "address": address, "ts": time.time(), "reason": reason,
            "exit_code": exit_code, "_wv": notice["_wv"],
        })
        # authoritative worker-failure notice (reference: the GCS
        # WORKER_DELTA pubsub channel): owners subscribe so borrow
        # reconciliation and recovery react to the recorded death instead
        # of waiting out probe timeouts. The structured {reason, exit_code}
        # lets error messages say WHY (preempted vs OOM vs crash vs drained).
        self.pubsub.publish("workers", notice)
        # drop the id index entries too (node-death and job-finish paths
        # bypass rpc_report_worker_death's by-id pop): the control store
        # must not grow a stale entry per worker/driver forever
        stale = [wid for wid, addr in self.worker_addr_by_id.items()
                 if addr == address]
        for wid in stale:
            self.worker_addr_by_id.pop(wid, None)

    async def rpc_register_worker(self, conn_id: int, payload: dict) -> dict:
        """Every core worker (driver or worker) announces its RPC address
        and host node at startup."""
        addr = payload.get("address", "")
        if addr:
            self.worker_addresses[addr] = payload.get("node_id", "")
            # a recycled address re-registering proves the process slot is
            # live again; clear any stale death record (durably: a failover
            # must not resurrect the death and reap the live process's
            # borrows)
            if self.dead_worker_addresses.pop(addr, None) is not None:
                # the superseded death must ALSO leave the delta log — a
                # cursor reconcile spanning it would otherwise replay the
                # death of a now-live process and reap its borrows. The
                # "live" delta takes its place so cursor readers see the
                # clear (full pulls already exclude cleared records).
                self._worker_deltas = collections.deque(
                    (v, w) for v, w in self._worker_deltas
                    if w.get("address") != addr)
                live = self._record_worker_delta(
                    {"address": addr, "dead": False})
                self._persist("worker_live",
                              {"address": addr, "_wv": live["_wv"]})
                self.pubsub.publish("workers", live)
            wid = payload.get("worker_id")
            if wid:
                self.worker_addr_by_id[wid] = addr
            job = self.jobs.get(payload.get("job_id", b""))
            if job is not None and payload.get("mode") == "driver":
                # add_job ran before the driver's RPC server existed; fill
                # the address in so finish_job can record the driver's death
                job["driver_address"] = addr
        return {"ok": True}

    async def rpc_report_worker_death(self, conn_id: int, payload: dict) -> dict:
        """A node daemon observed one of its worker processes exit; the
        report carries the structured cause (fate-sharing, OOM-kill, drain,
        chaos process_kill, plain crash) and the exit code."""
        addr = payload.get("address") or self.worker_addr_by_id.pop(
            payload.get("worker_id", b""), None)
        if addr:
            self.worker_addresses.pop(addr, None)
            self._mark_worker_dead(addr, reason=payload.get("reason", ""),
                                   exit_code=payload.get("exit_code"))
        return {"ok": True}

    def _dead_worker_wires(self) -> List[dict]:
        return [
            {"address": addr, "dead": True, "reason": rec.get("reason", ""),
             "exit_code": rec.get("exit_code"), "ts": rec.get("ts"),
             "_wv": rec.get("_wv", 0)}
            for addr, rec in self.dead_worker_addresses.items()
        ]

    async def rpc_get_workers_delta(self, conn_id: int, payload) -> dict:
        """Cursor reconcile for "workers"-channel subscribers: every death
        notice published since `cursor` in publish order, or one full
        retained-record snapshot when the cursor predates the bounded delta
        log. The wires are the SAME dicts the pubsub published (incl.
        `_wv`) — a subscriber that missed notices replays exactly what it
        missed, through the same handler (the node table's
        get_nodes_delta, mirrored; this replaces the legacy
        list_dead_workers snapshot path)."""
        cursor = int((payload or {}).get("cursor", -1))
        if cursor == self._worker_version:
            return {"version": self._worker_version, "updates": []}
        if (cursor < 0 or cursor > self._worker_version
                or not self._worker_deltas
                or cursor < self._worker_deltas[0][0] - 1):
            # cursor predates the retained log — or POSTDATES our counter
            # (a restarted, unpersisted store): full snapshot either way,
            # and the client RESETS its cursor to our version
            return {"version": self._worker_version, "full": True,
                    "workers": self._dead_worker_wires()}
        return {
            "version": self._worker_version,
            "updates": [w for ver, w in self._worker_deltas if ver > cursor],
        }

    async def rpc_check_worker_liveness(self, conn_id: int, payload: dict) -> dict:
        """Authoritative death lookup for a worker/driver RPC address:
        dead=True only when the process's exit (or its node's death) was
        actually recorded — an unreachable-but-undeclared address stays
        not-dead (the caller must keep waiting, not free)."""
        addr = payload["address"]
        if addr in self.dead_worker_addresses:
            return {"known": True, "dead": True}
        node_hex = self.worker_addresses.get(addr)
        if node_hex is not None:
            if node_hex:
                try:
                    info = self.nodes.get(bytes.fromhex(node_hex))
                except ValueError:
                    info = None
                if info is not None and info.state == pb.NODE_DEAD:
                    self.worker_addresses.pop(addr, None)
                    self._mark_worker_dead(addr)
                    return {"known": True, "dead": True}
            return {"known": True, "dead": False}
        return {"known": False, "dead": False}

    # ------------------------------------------------------------------
    # KV service (reference: gcs_service.proto InternalKV :633)
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # structured event export (reference: RayEventExport /
    # events_event_aggregator_service.proto + aggregator agent)
    # ------------------------------------------------------------------

    def _event(self, source: str, etype: str, message: str, **meta):
        self._event_seq += 1
        ev = {
            "seq": self._event_seq,
            "ts": time.time(),
            "source": source,       # node | actor | job | pg | autoscaler...
            "type": etype,          # REGISTERED / DEAD / DRAINING / ...
            "message": message,
            "meta": meta,
        }
        self.events.append(ev)
        self.pubsub.publish("events", ev)

    async def rpc_report_event(self, conn_id: int, payload: dict) -> dict:
        """Components (autoscaler, daemons, libraries) push their own
        structured events into the cluster stream."""
        self._event(payload.get("source", "external"),
                    payload.get("type", "EVENT"),
                    payload.get("message", ""),
                    **(payload.get("meta") or {}))
        return {"ok": True}

    async def rpc_list_events(self, conn_id: int, payload: dict) -> dict:
        limit = int(payload.get("limit", 1000))
        if limit <= 0:
            return {"events": []}  # out[-0:] would be the WHOLE ring
        source = payload.get("source")
        etype = payload.get("type")
        out = [
            ev for ev in self.events
            if (source is None or ev["source"] == source)
            and (etype is None or ev["type"] == etype)
        ]
        return {"events": out[-limit:]}

    async def rpc_kv_put(self, conn_id: int, payload: dict) -> dict:
        ns = self.kv.setdefault(payload.get("ns", ""), {})
        existed = payload["key"] in ns
        if not existed or payload.get("overwrite", True):
            ns[payload["key"]] = payload["value"]
            self._persist("kv_put", {
                "ns": payload.get("ns", ""), "key": payload["key"],
                "value": payload["value"],
            })
        return {"existed": existed}

    async def rpc_kv_get(self, conn_id: int, payload: dict) -> dict:
        ns = self.kv.get(payload.get("ns", ""), {})
        return {"value": ns.get(payload["key"])}

    async def rpc_kv_del(self, conn_id: int, payload: dict) -> dict:
        ns = self.kv.get(payload.get("ns", ""), {})
        deleted = ns.pop(payload["key"], None) is not None
        if deleted:
            self._persist("kv_del", {"ns": payload.get("ns", ""), "key": payload["key"]})
        return {"deleted": deleted}

    async def rpc_kv_keys(self, conn_id: int, payload: dict) -> dict:
        ns = self.kv.get(payload.get("ns", ""), {})
        prefix = payload.get("prefix", b"")
        return {"keys": [k for k in ns if k.startswith(prefix)]}

    # ------------------------------------------------------------------
    # pub/sub
    # ------------------------------------------------------------------

    async def rpc_chaos_set(self, conn_id: int, payload: dict) -> dict:
        """Chaos scenario hook (testing only): apply chaos/testing config
        flags to the control store at runtime — e.g. stall its responses
        mid-failover (see _private.chaos)."""
        from ray_tpu_torch._private import chaos

        GLOBAL_CONFIG.apply_system_config(payload.get("config", {}))
        chaos.reset()
        return {"ok": True, "role": chaos.role()}

    async def rpc_subscribe(self, conn_id: int, payload: dict) -> dict:
        channel = payload["channel"]
        self.pubsub.subscribe(conn_id, channel)
        # reply carries the channel's current publish seq: a resubscribing
        # client whose last-seen seq doesn't match knows it missed notices
        # (or that the store restarted with fresh counters) and reconciles.
        # For the node table the reply also carries the version cursor so
        # the reconcile can be a delta pull, not a full snapshot.
        reply = {"ok": True, "seq": self.pubsub.channel_seq(channel)}
        if channel == "nodes":
            reply["version"] = self._node_version
        elif channel == "workers":
            reply["version"] = self._worker_version
        return reply

    async def rpc_pubsub_stats(self, conn_id: int, payload) -> dict:
        """Observability for the fanout plane (bench_scale + tests): per-
        channel publish seq and shed counts."""
        return {
            "seq": dict(self.pubsub.seq),
            "dropped": dict(self.pubsub.dropped),
            "subscribers": {
                ch: len(subs) for ch, subs in self.pubsub._subs.items()
            },
        }

    async def rpc_publish(self, conn_id: int, payload: dict) -> dict:
        self.pubsub.publish(payload["channel"], payload["message"])
        return {"ok": True}

    # ------------------------------------------------------------------
    # job service (reference: gcs_service.proto JobInfo :69)
    # ------------------------------------------------------------------

    async def rpc_add_job(self, conn_id: int, payload: dict) -> dict:
        job_id = JobID.from_int(self._next_job)
        self._next_job += 1
        self.jobs[job_id.binary()] = {
            "job_id": job_id.binary(),
            "driver_address": payload.get("driver_address", ""),
            "start_time": time.time(),
            "finished": False,
        }
        self._persist("job", {"job": self.jobs[job_id.binary()],
                              "next_job": self._next_job})
        return {"job_id": job_id.binary()}

    async def rpc_finish_job(self, conn_id: int, payload: dict) -> dict:
        job = self.jobs.get(payload["job_id"])
        if job:
            job["finished"] = True
            job["end_time"] = time.time()
            self._event("job", "FINISHED", job.get("entrypoint", ""),
                        job_id=payload["job_id"].hex()
                        if isinstance(payload["job_id"], bytes)
                        else str(payload["job_id"]))
            self._persist("job", {"job": job})
            self.pubsub.publish("jobs", job)
            # the driver process is going away with its job: record its
            # address so owners can reconcile borrows it still held
            drv = job.get("driver_address")
            if drv:
                self.worker_addresses.pop(drv, None)
                self._mark_worker_dead(drv, reason="driver exited (job finished)")
            # Kill detached-from-driver resources: actors owned by the job.
            for rec in list(self.actors.values()):
                if (
                    rec.spec.job_id.binary() == payload["job_id"]
                    and rec.state != pb.ACTOR_DEAD
                    and not rec.spec.runtime_env.get("detached")
                ):
                    await self._kill_actor(rec, "job finished", no_restart=True)
        return {"ok": True}

    async def rpc_get_all_jobs(self, conn_id: int, payload) -> dict:
        return {"jobs": list(self.jobs.values())}

    # ------------------------------------------------------------------
    # submitted-job table (the job plane: ray_tpu_torch.job_submission —
    # reference: dashboard/modules/job JobInfoStorageClient, which keeps
    # job records in the GCS so they survive component restarts)
    # ------------------------------------------------------------------

    _JOB_TERMINAL = ("SUCCEEDED", "FAILED", "STOPPED")

    def _job_upsert(self, rec: dict) -> dict:
        """Upsert one submitted-job record: terminal states never
        transition (reference: JobStatus.is_terminal), every status change
        lands in the WAL, the event stream, and the flight recorder."""
        sid = rec.get("submission_id")
        if not sid:
            return {"ok": False, "error": "submission_id required"}
        old = self.submitted_jobs.get(sid)
        old_status = old.get("status") if old else None
        new_status = rec.get("status")
        if (old_status in self._JOB_TERMINAL
                and new_status != old_status):
            return {"ok": False, "error": f"job {sid} is terminal "
                                          f"({old_status})", "terminal": True}
        self.submitted_jobs[sid] = rec
        self._persist("subjob", rec)
        if new_status != old_status:
            self._event("job", new_status or "UPDATED",
                        rec.get("entrypoint", ""), submission_id=sid,
                        tenant=rec.get("tenant", ""),
                        detail=rec.get("message", ""))
            flight_recorder.record(
                "job", (new_status or "updated").lower(), sid=sid,
                tenant=rec.get("tenant", ""))
        return {"ok": True}

    async def rpc_job_put(self, conn_id: int, payload: dict) -> dict:
        return self._job_upsert(dict(payload["job"]))

    async def rpc_job_update(self, conn_id: int, payload: dict) -> dict:
        sid = payload.get("submission_id", "")
        rec = self.submitted_jobs.get(sid)
        if rec is None:
            return {"ok": False, "error": f"no job {sid!r}"}
        merged = {**rec, **(payload.get("fields") or {})}
        return self._job_upsert(merged)

    async def rpc_job_get(self, conn_id: int, payload: dict) -> dict:
        return {"job": self.submitted_jobs.get(payload.get("submission_id", ""))}

    async def rpc_job_list(self, conn_id: int, payload) -> dict:
        """Paginated listing (newest first) with tenant/status filters —
        the dashboard /api/jobs and CLI `job list` surface."""
        payload = payload or {}
        tenant = payload.get("tenant")
        status = payload.get("status")
        jobs = [
            j for j in self.submitted_jobs.values()
            if (tenant is None or j.get("tenant") == tenant)
            and (status is None or j.get("status") == status)
        ]
        jobs.sort(key=lambda j: (-(j.get("submit_time") or 0.0),
                                 j.get("submission_id", "")))
        offset = max(0, int(payload.get("offset", 0)))
        limit = max(1, min(1000, int(payload.get("limit", 100))))
        return {"total": len(jobs), "offset": offset, "limit": limit,
                "jobs": jobs[offset:offset + limit]}

    async def rpc_report_demand(self, conn_id: int, payload: dict) -> dict:
        """Pushed resource demand with expiry (reference: autoscaler sdk
        request_resources) — the elastic-train controller posts its unmet
        target width here; empty shapes withdraw the key immediately."""
        key = payload.get("key", "")
        if not key:
            return {"ok": False, "error": "key required"}
        shapes = payload.get("shapes") or []
        if not shapes:
            self.reported_demand.pop(key, None)
            return {"ok": True}
        ttl = float(payload.get("ttl_s")
                    or GLOBAL_CONFIG.get("report_demand_ttl_s"))
        self.reported_demand[key] = {
            # reporters send human-unit floats; normalize to the wire
            # (fixed-point) shape format the demand consumers bin-pack
            "shapes": [ResourceSet(dict(s)).to_wire() for s in shapes],
            "expires": time.monotonic() + ttl,
        }
        return {"ok": True}

    # ------------------------------------------------------------------
    # actor service (reference: gcs_actor_manager.h:94)
    # ------------------------------------------------------------------

    async def rpc_register_actor(self, conn_id: int, payload: dict) -> dict:
        spec = TaskSpec.from_wire(payload["spec"])
        actor_id = spec.actor_id.binary()
        if actor_id in self.actors:
            return {"ok": True, "already": True}
        rec = ActorRecord(spec)
        self.actors[actor_id] = rec
        if rec.name:
            key = (spec.runtime_env.get("namespace", ""), rec.name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing is not None and existing.state != pb.ACTOR_DEAD:
                    del self.actors[actor_id]
                    raise ValueError(f"Actor name {rec.name!r} already taken")
            self.named_actors[key] = actor_id
        self._persist("actor", rec.to_persist())
        rec.pending_create = spawn(self._create_actor(rec))
        return {"ok": True}

    async def _create_actor(self, rec: ActorRecord, exclude: Optional[Set[bytes]] = None):
        """Schedule + create an actor (reference: gcs_actor_scheduler.cc:50)."""
        actor_hex = rec.spec.actor_id.hex()[:8]
        try:
            deadline = time.monotonic() + GLOBAL_CONFIG.get("actor_creation_timeout_s")
            # nodes that rejected this actor (stale gossip view); cleared when
            # no candidate is left so freed-up capacity is retried
            rejected: Set[bytes] = set()
            attempt = 0
            while True:
                node_id = self._pick_node_for(
                    rec.spec, (exclude or set()) | rejected, rotation=attempt)
                while node_id is None:
                    self._check_actor_pg_alive(rec)
                    rejected.clear()
                    await asyncio.sleep(0.2)
                    if rec.state == pb.ACTOR_DEAD:
                        return
                    node_id = self._pick_node_for(
                        rec.spec, exclude or set(), rotation=attempt)
                # Optimistically deduct from the gossiped view so a burst of
                # concurrent creates doesn't all pick the same node and
                # thundering-herd the daemon (reference: GCS scheduler deducts
                # on placement); the next heartbeat restores ground truth.
                deducted = False
                if rec.spec.strategy.kind != pb.STRATEGY_PLACEMENT_GROUP:
                    avail = self.node_available.get(node_id)
                    if avail is not None:
                        self.node_available[node_id] = avail - rec.spec.resources
                        deducted = True
                        # the deduction must hit the availability change log
                        # too: the daemon's next heartbeat reports the SAME
                        # post-placement value, so the equality check there
                        # never bumps — cursor readers (the autoscaler's
                        # delta poll) would keep the pre-placement row and
                        # bin-pack demand into phantom free capacity
                        self._bump_avail(node_id)
                daemon = await self._daemon(node_id)
                reply = None
                while True:
                    try:
                        # per-attempt deadline well under the overall budget:
                        # a dropped call is retried against the SAME node
                        # (daemon create is idempotent by actor id and the
                        # original may still be in flight there) instead of
                        # burning the whole deadline or racing a second node.
                        # Long __init__s are fine: timed-out retries coalesce
                        # onto the in-flight creation until the deadline.
                        attempt_timeout = min(
                            5.0, GLOBAL_CONFIG.get("actor_creation_timeout_s"))
                        reply = await daemon.call(
                            "create_actor",
                            {"spec": rec.spec.to_wire()},
                            timeout=attempt_timeout,
                        )
                        break
                    except (RpcError, asyncio.TimeoutError) as e:
                        node = self.nodes.get(node_id)
                        node_dead = node is None or node.state != pb.NODE_ALIVE
                        if (time.monotonic() >= deadline
                                or rec.state == pb.ACTOR_DEAD):
                            raise RuntimeError(
                                f"create_actor RPC failed: {e}") from None
                        if node_dead:
                            break  # re-pick a different node below
                        await asyncio.sleep(0.3)
                if reply is None:
                    # target node died mid-create: refund and re-pick
                    if deducted and node_id in self.node_available:
                        self.node_available[node_id] = (
                            self.node_available[node_id] + rec.spec.resources
                        )
                        self._bump_avail(node_id)
                    rejected.add(node_id)
                    attempt += 1
                    continue
                if reply.get("ok"):
                    break
                if deducted and node_id in self.node_available:
                    # the daemon holds no resources for a rejected create —
                    # refund the optimistic deduction or repeated retries
                    # drive the gossiped view negative and starve peers
                    self.node_available[node_id] = (
                        self.node_available[node_id] + rec.spec.resources
                    )
                    self._bump_avail(node_id)
                if (
                    not reply.get("permanent")
                    and "insufficient resources" in str(reply.get("error", ""))
                    and time.monotonic() < deadline
                    and rec.state != pb.ACTOR_DEAD
                ):
                    # the gossiped view raced the daemon's ground truth
                    # (in-flight leases): re-pick elsewhere after the next
                    # beat instead of declaring the actor dead (reference:
                    # gcs actor scheduler requeues on lease rejection)
                    rejected.add(node_id)
                    attempt += 1
                    await asyncio.sleep(0.3)
                    continue
                raise RuntimeError(reply.get("error", "creation failed"))
            rec.node_id = node_id
            rec.worker_id = reply["worker_id"]
            rec.worker_address = reply["worker_address"]
            rec.state = pb.ACTOR_ALIVE
            logger.info("actor %s ALIVE on %s", actor_hex, rec.worker_address)
            self._event("actor", "ALIVE", rec.name or actor_hex[:12],
                        actor_id=actor_hex)
            self._persist_actor(rec)
            self.pubsub.publish("actors", rec.to_wire())
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            logger.warning("actor %s creation failed: %s", actor_hex, e)
            self._event("actor", "CREATION_FAILED", str(e),
                        actor_id=actor_hex)
            rec.state = pb.ACTOR_DEAD
            rec.death_cause = f"creation failed: {e}"
            self._persist_actor(rec)
            self.pubsub.publish("actors", rec.to_wire())

    def _check_actor_pg_alive(self, rec: ActorRecord) -> None:
        """An actor bound to a removed (or vanished) placement group can
        never be placed — raise so _create_actor marks it DEAD instead of
        polling forever (reference: gcs_actor_manager fails actors whose PG
        is removed)."""
        strategy = rec.spec.strategy
        if strategy.kind != pb.STRATEGY_PLACEMENT_GROUP:
            return
        pg = self.placement_groups.get(bytes.fromhex(strategy.placement_group_id))
        if pg is None or pg.state == pb.PG_REMOVED:
            raise RuntimeError("placement group removed before actor placement")

    def _pick_node_for(self, spec: TaskSpec, exclude: Set[bytes],
                       rotation: int = 0) -> Optional[bytes]:
        """Pick a feasible node. Hybrid policy: pack onto the most-utilized
        feasible node first (reference: hybrid_scheduling_policy.h:50).
        `rotation` rotates among equivalent choices on retries (PG any-bundle
        placements), so a rejected node isn't re-picked forever."""
        strategy = spec.strategy
        if strategy.kind == pb.STRATEGY_PLACEMENT_GROUP:
            # PG actors go to the node holding the bundle; resources come
            # from the bundle's reservation, not the gossiped availability
            pg = self.placement_groups.get(
                bytes.fromhex(strategy.placement_group_id))
            if pg is None or pg.state != pb.PG_CREATED:
                return None  # caller's loop retries until the PG commits
            if strategy.bundle_index >= 0:
                return pg.placements.get(strategy.bundle_index)
            nodes = [n for n in pg.placements.values() if n not in exclude]
            if not nodes:
                # all bundle nodes rejected recently: fall back to rotating
                # over every placement (bundles free up as actors exit)
                nodes = list(pg.placements.values())
            if not nodes:
                return None
            return nodes[rotation % len(nodes)]
        if strategy.kind == pb.STRATEGY_NODE_AFFINITY and strategy.node_id:
            nid = bytes.fromhex(strategy.node_id)
            info = self.nodes.get(nid)
            if info and info.state == pb.NODE_ALIVE and nid not in exclude:
                avail = self.node_available.get(nid)
                if avail and spec.resources.is_subset_of(avail):
                    return nid
            if not strategy.soft:
                return None
        candidates = []
        for nid, info in self.nodes.items():
            if info.state != pb.NODE_ALIVE or nid in exclude:
                continue
            if pb.is_sim_node(info.labels):
                continue  # scale-harness nodes never take real actors
            if strategy.label_selector:
                if not pb.labels_match(info.labels, strategy.label_selector):
                    continue
            avail = self.node_available.get(nid)
            if avail is None or not spec.resources.is_subset_of(avail):
                continue
            total = info.resources
            util = 1.0 - (
                sum(avail.to_wire().values()) / max(1, sum(total.to_wire().values()))
            )
            candidates.append((util, nid))
        if not candidates:
            return None
        if strategy.kind == pb.STRATEGY_SPREAD:
            candidates.sort(key=lambda c: c[0])  # least utilized first
        else:
            candidates.sort(key=lambda c: -c[0])  # pack
        return candidates[0][1]

    async def rpc_report_actor_death(self, conn_id: int, payload: dict) -> dict:
        """A daemon reports that a worker hosting an actor died."""
        rec = self.actors.get(payload["actor_id"])
        if rec is None:
            return {"ok": False}
        await self._on_actor_worker_death(rec, payload.get("reason", "worker died"))
        return {"ok": True}

    async def _on_actor_worker_death(self, rec: ActorRecord, reason: str,
                                     planned: bool = False):
        if rec.state == pb.ACTOR_DEAD:
            return
        actor_hex = rec.spec.actor_id.hex() if rec.spec.actor_id else ""
        flight_recorder.record(
            "actor", "worker_death", actor=actor_hex[:12],
            reason=reason, planned=planned, restarts=rec.num_restarts)
        max_restarts = rec.spec.max_restarts
        # planned removals (drain/preemption) never charge the user's
        # restart budget: only unplanned crashes count against max_restarts.
        # max_restarts=0 actors are non-restartable by contract — even a
        # planned removal kills them (with a death cause saying WHY, so the
        # owner can rebuild warm during the drain window).
        unplanned = rec.num_restarts - rec.planned_restarts
        if ((planned and max_restarts != 0)
                or max_restarts == -1 or unplanned < max_restarts):
            rec.num_restarts += 1
            if planned:
                rec.planned_restarts += 1
            rec.state = pb.ACTOR_RESTARTING
            dead_node = rec.node_id
            rec.worker_id = None
            rec.worker_address = ""
            self._persist_actor(rec)
            self.pubsub.publish("actors", rec.to_wire())
            exclude = set()
            if dead_node is not None and self.nodes.get(dead_node, None) is not None:
                if self.nodes[dead_node].state != pb.NODE_ALIVE:
                    exclude.add(dead_node)
            rec.pending_create = spawn(self._create_actor(rec, exclude=exclude))
        else:
            rec.state = pb.ACTOR_DEAD
            rec.death_cause = reason
            self._persist_actor(rec)
            self.pubsub.publish("actors", rec.to_wire())

    async def rpc_get_actor_info(self, conn_id: int, payload: dict) -> dict:
        rec = self.actors.get(payload["actor_id"])
        return {"actor": rec.to_wire() if rec else None}

    async def rpc_get_named_actor(self, conn_id: int, payload: dict) -> dict:
        key = (payload.get("namespace", ""), payload["name"])
        actor_id = self.named_actors.get(key)
        if actor_id is None:
            return {"actor": None}
        rec = self.actors.get(actor_id)
        return {"actor": rec.to_wire() if rec else None}

    async def rpc_list_actors(self, conn_id: int, payload) -> dict:
        return {"actors": [r.to_wire() for r in self.actors.values()]}

    async def rpc_kill_actor(self, conn_id: int, payload: dict) -> dict:
        rec = self.actors.get(payload["actor_id"])
        if rec is None:
            return {"ok": False}
        await self._kill_actor(
            rec, payload.get("reason", "ray_tpu_torch.kill"),
            no_restart=payload.get("no_restart", True),
        )
        return {"ok": True}

    async def _kill_actor(self, rec: ActorRecord, reason: str, no_restart: bool):
        if rec.pending_create and not rec.pending_create.done():
            rec.pending_create.cancel()
        if no_restart:
            rec.state = pb.ACTOR_DEAD
            rec.death_cause = reason
        if rec.node_id is not None and rec.worker_id:
            try:
                daemon = await self._daemon(rec.node_id)
                await daemon.call(
                    "kill_worker",
                    {"worker_id": rec.worker_id, "reason": reason},
                    timeout=5,
                )
            except Exception:  # noqa: BLE001
                pass
        if not no_restart:
            await self._on_actor_worker_death(rec, reason)
        else:
            self._persist_actor(rec)
            self.pubsub.publish("actors", rec.to_wire())

    # ------------------------------------------------------------------
    # placement groups (reference: gcs_placement_group_manager.h, 2PC
    # prepare/commit node_manager.proto:515-525)
    # ------------------------------------------------------------------

    async def rpc_create_placement_group(self, conn_id: int, payload: dict) -> dict:
        pg_id = PlacementGroupID(payload["pg_id"])
        bundles = [pb.Bundle.from_wire(b) for b in payload["bundles"]]
        strategy = payload.get("strategy", pb.PG_PACK)
        rec = PlacementGroupRecord(
            pg_id, bundles, strategy, payload.get("name", ""),
            label_selector=payload.get("labels") or {},
        )
        self.placement_groups[pg_id.binary()] = rec
        self._persist("pg", rec.to_persist())
        spawn(self._schedule_pg(rec))
        return {"ok": True}

    def _place_bundles(self, rec: PlacementGroupRecord) -> Optional[Dict[int, bytes]]:
        """Bin-pack bundles onto live nodes per strategy (reference:
        bundle_scheduling_policy.h:74-101)."""
        avail = {
            nid: ResourceSet.from_wire(a.to_wire())
            for nid, a in self.node_available.items()
            if nid in self.nodes and self.nodes[nid].state == pb.NODE_ALIVE
            and not pb.is_sim_node(self.nodes[nid].labels)
            and pb.labels_match(self.nodes[nid].labels, rec.label_selector)
        }
        placements: Dict[int, bytes] = {}
        if rec.strategy == pb.PG_TOPOLOGY_STRICT_PACK:
            return self._place_topology_strict(rec, avail)
        if rec.strategy in (pb.PG_STRICT_PACK,):
            for nid, a in avail.items():
                need = ResourceSet()
                for b in rec.bundles:
                    need = need + b.resources
                if need.is_subset_of(a):
                    return {b.index: nid for b in rec.bundles}
            return None
        used_nodes: Set[bytes] = set()
        for b in sorted(rec.bundles, key=lambda b: -sum(b.resources.to_wire().values())):
            candidates = [
                (nid, a) for nid, a in avail.items() if b.resources.is_subset_of(a)
            ]
            if rec.strategy == pb.PG_STRICT_SPREAD:
                candidates = [(n, a) for n, a in candidates if n not in used_nodes]
            if not candidates:
                return None
            if rec.strategy in (pb.PG_SPREAD, pb.PG_STRICT_SPREAD):
                candidates.sort(key=lambda c: (c[0] in used_nodes, -sum(c[1].to_wire().values())))
            else:  # PACK: prefer already-used nodes
                candidates.sort(key=lambda c: (c[0] not in used_nodes, -sum(c[1].to_wire().values())))
            nid = candidates[0][0]
            placements[b.index] = nid
            used_nodes.add(nid)
            avail[nid] = avail[nid] - b.resources
        return placements

    def _place_topology_strict(
        self, rec: PlacementGroupRecord, avail: Dict[bytes, ResourceSet]
    ) -> Optional[Dict[int, bytes]]:
        """Topology-aware gang placement (reference:
        topology_bundle_scheduling_policy.h:89; the JAX package places on a
        TPU slice's coordinates): one bundle per host, hosts chosen to
        minimize the bounding box of their coordinates in one NVLink
        domain, so (0,0),(0,1),(0,2) beats any set including a far-away
        host. Greedy: for each
        anchor host, grow by nearest manhattan distance; keep the set with
        the smallest (max-distance, sum-distance) score. Bundle index i maps
        to the i-th host in row-major coordinate order (gang rank ↔ physical
        position)."""
        n = len(rec.bundles)

        def coord_of(nid: bytes):
            raw = self.nodes[nid].labels.get(pb.GPU_COORD_LABEL)
            if not raw:
                return None
            try:
                return tuple(int(x) for x in raw.split(","))
            except ValueError:
                return None

        # per-host feasibility: any bundle must fit any chosen host (one
        # bundle lands per host; assignment is by rank, not by size).
        # Candidates are grouped by NVLink domain (gpu-domain-name label):
        # coordinates are only meaningful WITHIN one domain — two domains
        # both have a host at (0,0), and a "tight" set spanning domains has
        # no NVLink between them at all.
        groups: Dict[str, list] = {}
        for nid, a in avail.items():
            coord = coord_of(nid)
            if coord is None:
                continue
            if not all(b.resources.is_subset_of(a) for b in rec.bundles):
                continue
            domain = self.nodes[nid].labels.get("gpu-domain-name", "")
            groups.setdefault(domain, []).append((nid, coord))
        candidates = None
        for members in groups.values():
            if len(members) >= n:
                candidates = (members if candidates is None
                              else min(candidates, members, key=len))
        if candidates is None:
            return None

        def dist(a, b):
            return sum(abs(x - y) for x, y in zip(a, b))

        best: Optional[tuple] = None
        for anchor_nid, anchor in candidates:
            ranked = sorted(
                candidates, key=lambda cn: (dist(cn[1], anchor), cn[1])
            )[:n]
            # score the SET, not the anchor view: two hosts each at
            # distance d from the anchor can be 2d apart, so the true
            # extent is the pairwise maximum
            dmax = max(
                (dist(a, b) for _, a in ranked for _, b in ranked),
                default=0,
            )
            dsum = sum(dist(c, anchor) for _, c in ranked)
            score = (dmax, dsum)
            if best is None or score < best[0]:
                best = (score, ranked)
        chosen = sorted(best[1], key=lambda cn: cn[1])  # row-major rank order
        return {
            b.index: chosen[i][0]
            for i, b in enumerate(sorted(rec.bundles, key=lambda b: b.index))
        }

    async def _schedule_pg(self, rec: PlacementGroupRecord):
        deadline = time.monotonic() + GLOBAL_CONFIG.get("placement_group_timeout_s")
        while rec.state == pb.PG_PENDING:
            placements = self._place_bundles(rec)
            if placements is None:
                if time.monotonic() > deadline:
                    rec.state = pb.PG_REMOVED
                    self._event("pg", "UNSCHEDULABLE",
                                rec.name or rec.pg_id.hex()[:12],
                                pg_id=rec.pg_id.hex())
                    self._persist("pg_up", rec.to_wire())
                    self.pubsub.publish("placement_groups", rec.to_wire())
                    return
                await asyncio.sleep(0.2)
                continue
            # 2PC prepare
            by_node: Dict[bytes, List[pb.Bundle]] = {}
            for b in rec.bundles:
                by_node.setdefault(placements[b.index], []).append(b)
            prepared: List[bytes] = []
            ok = True
            for nid, bundles in by_node.items():
                try:
                    daemon = await self._daemon(nid)
                    r = await daemon.call("prepare_bundles", {
                        "pg_id": rec.pg_id.binary(),
                        "bundles": [b.to_wire() for b in bundles],
                    }, timeout=10)
                    if not r.get("ok"):
                        ok = False
                        break
                    prepared.append(nid)
                except Exception:  # noqa: BLE001
                    ok = False
                    break
            if ok:
                # commit phase: a daemon dying here must roll everything back,
                # or the surviving nodes leak their prepared reservations
                try:
                    for nid in by_node:
                        daemon = await self._daemon(nid)
                        await daemon.call(
                            "commit_bundles", {"pg_id": rec.pg_id.binary()}, timeout=10
                        )
                except Exception:  # noqa: BLE001 — node died mid-2PC
                    ok = False
            if not ok:
                for nid in prepared:
                    try:
                        daemon = await self._daemon(nid)
                        await daemon.call("cancel_bundles", {"pg_id": rec.pg_id.binary()}, timeout=5)
                    except Exception:  # noqa: BLE001
                        pass
                await asyncio.sleep(0.2)
                continue
            rec.placements = placements
            rec.state = pb.PG_CREATED
            self._persist("pg_up", rec.to_wire())
            self.pubsub.publish("placement_groups", rec.to_wire())
            return

    async def rpc_get_placement_group(self, conn_id: int, payload: dict) -> dict:
        rec = self.placement_groups.get(payload["pg_id"])
        return {"pg": rec.to_wire() if rec else None}

    async def rpc_list_placement_groups(self, conn_id: int, payload) -> dict:
        return {"pgs": [r.to_wire() for r in self.placement_groups.values()]}

    # ------------------------------------------------------------------
    # task events + metrics ingestion (reference: gcs_task_manager.h task
    # event history; stats/metric.h registry exported via the agent)
    # ------------------------------------------------------------------

    async def rpc_report_task_events(self, conn_id: int, payload: dict) -> dict:
        cap = GLOBAL_CONFIG.get("task_event_buffer_max")
        self.task_events_dropped += int(payload.get("dropped", 0) or 0)
        for ev in payload.get("events", []):
            self.task_events.append(ev)
        if len(self.task_events) > cap:
            # store-side trims are loss too: the history the timeline reads
            # must confess its own gaps
            self.task_events_dropped += len(self.task_events) - cap
            while len(self.task_events) > cap:
                self.task_events.popleft()
        return {"ok": True}

    async def rpc_list_task_events(self, conn_id: int, payload) -> dict:
        limit = (payload or {}).get("limit", 0)
        events = list(self.task_events)
        if limit:
            events = events[-limit:]
        return {"events": events, "dropped": self.task_events_dropped}

    async def rpc_report_metrics(self, conn_id: int, payload: dict) -> dict:
        """Metric ingestion: delta payloads ACCUMULATE per reporter
        (counters/histogram buckets add, gauges replace — histograms merge
        exactly across flushes and across processes), legacy full snapshots
        replace the reporter's series wholesale."""
        from ray_tpu_torch.util.metrics import merge_series

        wid = payload["worker_id"]
        series = payload.get("metrics", [])
        if payload.get("delta"):
            rec = self.metrics_by_worker.get(wid)
            if rec is None or "acc" not in rec:
                rec = self.metrics_by_worker[wid] = {"ts": time.time(),
                                                     "acc": {}}
            seq = payload.get("seq")
            if seq is not None:
                # reporters retry a frozen batch verbatim until acked:
                # dedup by sequence so an applied-but-unacked flush never
                # double-counts (the exactly-once half of delta shipping)
                if rec.get("last_seq") is not None \
                        and seq <= rec["last_seq"]:
                    rec["ts"] = time.time()
                    return {"ok": True, "dup": True}
                rec["last_seq"] = seq
            rec["ts"] = time.time()
            # merge only; the flat series list is materialized lazily at
            # scrape time (get_metrics) — per-report rebuilds would be
            # O(series) on the ingestion path at every flush from every node
            merge_series(rec["acc"], series, True)
        else:
            self.metrics_by_worker[wid] = {
                "ts": time.time(),
                "metrics": series,
            }
        # prune reporters that stopped (died/reaped) — without this the
        # table grows per reporter ever seen and exports stale gauges.
        # Throttled: at 1000 nodes a per-report scan of every reporter
        # would make ingestion O(reporters^2) per flush period.
        now = time.time()
        if now - getattr(self, "_metrics_prune_ts", 0.0) > 5.0:
            self._metrics_prune_ts = now
            stale = now - 60.0
            for w in [w for w, s in self.metrics_by_worker.items()
                      if s["ts"] < stale]:
                del self.metrics_by_worker[w]
        return {"ok": True}

    async def rpc_get_metrics(self, conn_id: int, payload) -> dict:
        from ray_tpu_torch.util.metrics import snapshot_all

        out = {
            w: {"ts": s["ts"],
                "metrics": (list(s["acc"].values()) if "acc" in s
                            else s.get("metrics", []))}
            for w, s in self.metrics_by_worker.items()
        }
        # the store's OWN series (pubsub shed counters etc.) join the scrape
        # under a reserved reporter key — no reporter loop ships them
        out["__control_store__"] = {"ts": time.time(),
                                    "metrics": snapshot_all()}
        return {"workers": out}

    async def rpc_dump_flight_recorder(self, conn_id: int, payload) -> dict:
        return flight_recorder.dump()

    async def rpc_remove_placement_group(self, conn_id: int, payload: dict) -> dict:
        rec = self.placement_groups.get(payload["pg_id"])
        if rec is None:
            return {"ok": False}
        rec.state = pb.PG_REMOVED
        self._persist("pg_up", rec.to_wire())
        for nid in set(rec.placements.values()):
            try:
                daemon = await self._daemon(nid)
                await daemon.call("return_bundles", {"pg_id": rec.pg_id.binary()}, timeout=5)
            except Exception as e:  # noqa: BLE001 — best-effort: node may be dead
                logger.debug("return_bundles to node %s skipped during PG "
                             "removal: %r", nid.hex()[:12], e)
        self.pubsub.publish("placement_groups", rec.to_wire())
        return {"ok": True}


def _leader_lock_file(persist_dir: str):
    os.makedirs(persist_dir, exist_ok=True)
    return open(os.path.join(persist_dir, "LEADER"), "a+")


def _try_flock(f) -> bool:
    import fcntl

    try:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        return True
    except OSError:
        return False


async def _acquire_leadership(persist_dir: str, blocking: bool):
    """Exclusive flock on <persist_dir>/LEADER (reference: gcs
    leader_election/leader_elector.h via k8s Lease objects — here the
    shared persist dir IS the coordination medium). Blocking mode parks in
    a thread on the kernel lock, waking the instant the leader dies.
    Returns the held file object (the lock lives as long as the process),
    or None when non-blocking and another control store leads."""
    import fcntl

    f = _leader_lock_file(persist_dir)
    if not _try_flock(f):
        if not blocking:
            f.close()
            return None
        await asyncio.to_thread(fcntl.flock, f.fileno(), fcntl.LOCK_EX)
    f.seek(0)
    f.truncate()
    f.write(f"pid={os.getpid()}\n")
    f.flush()
    return f


async def _wait_port_free(host: str, port: int, timeout_s: float = 60.0):
    """Wait for the dead leader's listening socket to vanish; only
    EADDRINUSE is retried — any other bind error (bad host, port owned by
    an unrelated service) must surface instead of wedging the failover
    silently while we hold the leadership lock."""
    import errno
    import socket

    deadline = time.monotonic() + timeout_s
    attempt = 0
    while True:
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            probe.bind((host, port))
            return
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
            attempt += 1
            if attempt % 10 == 1:
                logger.warning(
                    "takeover address %s:%d still bound; waiting", host, port)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"takeover address {host}:{port} never freed up "
                    f"(held by a process that is not the dead leader?)")
        finally:
            probe.close()
        await asyncio.sleep(0.5)


def _standby_apply(store: ControlStore, items: list) -> int:
    """Fold tailed WAL items into the standby's warm tables. A "snapshot"
    item means the leader compacted past what we saw: reset and re-seed."""
    applied = 0
    for kind, payload in items:
        try:
            if kind == "snapshot":
                store._reset_tables()
                store._apply_snapshot(payload)
            else:
                store._apply_wal_record(payload)
            applied += 1
        except Exception:  # noqa: BLE001 — skip bad record, keep the rest
            logger.exception("standby: skipping bad tailed record")
    return applied


async def _standby_wait(store: ControlStore, persist_dir: str, lease) -> str:
    """Warm-standby wait loop: tail the WAL into live tables while watching
    for leadership — the flock freeing (leader process died; zero-latency
    kernel wakeup) or the lease going stale past `store_failover_timeout_s`
    (leader alive but WEDGED; the flock never frees, the lease stops
    renewing). Returns how leadership was won; the open tailer and any won
    flock are stashed on the store for the takeover sequence."""
    import fcntl
    import threading

    from ray_tpu_torch._private import persistence

    flight_recorder.record("store", "standby_waiting", dir=persist_dir)
    tail = persistence.open_tailer(persist_dir)
    loop = asyncio.get_running_loop()
    won_flock = asyncio.Event()
    holder: list = []

    def park_on_flock():
        f = _leader_lock_file(persist_dir)
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)  # parks until leader death
        holder.append(f)
        loop.call_soon_threadsafe(won_flock.set)

    threading.Thread(target=park_on_flock, daemon=True).start()
    period = min(0.25, GLOBAL_CONFIG.get("store_fence_epoch_renew_s"))
    timeout = GLOBAL_CONFIG.get("store_failover_timeout_s")
    tailed = 0
    while True:
        tailed += _standby_apply(store, tail.poll())
        if won_flock.is_set():
            mode = "leader_died"
            break
        # stale-lease takeover covers the wedged-zombie case — but only
        # when a leader ever held the lease (an empty dir must wait for
        # the flock, not preempt a primary that is still starting up)
        if lease.read() and lease.staleness_s() > timeout:
            mode = "lease_stale"
            break
        await asyncio.sleep(period)
    logger.info("standby won leadership (%s) after tailing %d record(s)",
                mode, tailed)
    store._standby_tail = tail
    # pin the won flock (if any) for the process lifetime — dropping the
    # file object would release the kernel lock and let a second standby
    # "win" while we serve
    store._leader_flock = holder
    return mode


async def _lease_renew_loop(store: ControlStore, lease):
    """The active leader's heartbeat on the lease file. A failed renewal
    means a newer epoch took over: this process is FENCED and exits before
    it can ack another mutation (its WAL handle is fenced independently —
    this loop just makes the exit prompt instead of lazy)."""
    period = GLOBAL_CONFIG.get("store_fence_epoch_renew_s")
    while True:
        await asyncio.sleep(period)
        try:
            ok = await asyncio.to_thread(lease.renew)
        except OSError:
            continue  # transient fs hiccup; the WAL fence still protects
        if not ok:
            store._fenced("lease renewal")


async def run_control_store(host: str, port: int, ready_file: Optional[str] = None,
                            persist_dir: Optional[str] = None,
                            standby: bool = False):
    """Serve the control store; with `standby=True`, tail the shared WAL
    into warm in-memory tables while waiting for leadership (leader death
    frees the flock instantly; a wedged leader's lease goes stale), then
    bump the fencing epoch, fold the tail into a fresh snapshot — which
    unlinks the old leader's WAL so a zombie cannot apply a late mutation —
    and serve at the SAME address: clients' auto-reconnect finds the new
    incumbent without re-configuration (reference: GCS HA = leader election
    + Redis/RocksDB-backed state + NotifyGCSRestart fan-out; here the
    restart notification is the daemons' re-register-on-unknown heartbeat
    path plus the subscribers' seq-mismatch cursor reconcile)."""
    from ray_tpu_torch._private.store_ha import LeaderLease

    lock = None
    lease = LeaderLease(persist_dir) if persist_dir else None
    if standby:
        if not persist_dir or port == 0:
            raise ValueError(
                "standby mode needs --persist-dir (shared WAL) and a fixed "
                "--port (takeover address)")
        GLOBAL_CONFIG.apply_system_config({"control_store_persist": True})
        store = ControlStore(persist_dir=None)  # warm tables, no WAL yet
        mode = await _standby_wait(store, persist_dir, lease)
        won_ts = time.time()
        stale_pid = lease.read().get("pid")  # before acquire() overwrites it
        epoch = lease.acquire()
        flight_recorder.record("store", "takeover", epoch=epoch, mode=mode)
        from ray_tpu_torch._private.persistence import WalStore

        # attach the WAL at the bumped epoch FIRST: the sqlite backend
        # fences the old leader's appends at this instant, so the final
        # tail drain below is guaranteed complete
        wal = WalStore(
            persist_dir,
            compact_every=GLOBAL_CONFIG.get("control_store_wal_compact_every"),
            epoch=epoch,
        )
        tail = store._standby_tail
        # final drain: loop while the tail holds back records behind an
        # uncovered seq gap (a snapshot read that raced the dead leader's
        # last compaction) — with the leader gone/fenced, the covering
        # snapshot is stable and a few retries must resolve it
        for attempt in range(20):
            items = tail.poll()
            _standby_apply(store, items)
            if not items and tail.drained:
                break
            if not tail.drained:
                await asyncio.sleep(0.05)
        else:
            logger.error(
                "takeover drain still holding records behind a seq gap "
                "after retries; proceeding with the last covered state")
        tail.close()
        wal.adopt_seq(tail.last_seq)
        store._wal = wal
        store.epoch = epoch
        store._recovered = True  # tables came from the tail, not recover()
        if not store.nodes and not store.kv and not store.actors:
            logger.warning(
                "taking over %s with EMPTY state — the old leader "
                "persisted nothing (control_store_persist off?)", persist_dir)
        # fold everything into a fresh epoch-owned snapshot; for the file
        # backend this unlinks the old leader's WAL inode (the fence)
        wal.snapshot(store._snapshot_state())
        store._activate_recovered()
        if mode == "lease_stale" and stale_pid and stale_pid != os.getpid():
            # a WEDGED leader never runs its renewal loop, so it will
            # neither fence-exit nor release the takeover port — it is
            # already fenced at the durable layer, so finish the job
            # (same-host STONITH) before waiting on its socket
            logger.warning(
                "killing wedged old leader pid=%s (lease stale, fenced "
                "at epoch %d)", stale_pid, epoch)
            try:
                os.kill(int(stale_pid), 9)
            except (OSError, ValueError):
                pass  # already gone
        await _wait_port_free(host, port)
        addr = await store.start(host, port)
        serving_ts = time.time()
        spawn(_lease_renew_loop(store, lease))
        logger.info("standby takeover complete: serving at %s (epoch %d)",
                    addr, epoch)
        if ready_file:
            # rtlint: disable=R001 one-shot takeover marker; written once before the run-forever wait
            with open(ready_file, "w") as f:
                json.dump({"address": addr, "epoch": epoch, "mode": mode,
                           "won_ts": won_ts, "serving_ts": serving_ts}, f)
        await asyncio.Event().wait()  # run forever
        return
    epoch = 0
    if persist_dir:
        # the active leader always marks leadership, persist flag or not —
        # otherwise a standby pointed here would instantly "win" while the
        # leader is alive
        lock = await _acquire_leadership(persist_dir, blocking=False)
        if lock is None:
            raise RuntimeError(
                f"another control store already leads {persist_dir}")
        epoch = lease.acquire()
    store = ControlStore(persist_dir=persist_dir, epoch=epoch)
    addr = await store.start(host, port)
    if lease is not None and lease.epoch:
        spawn(_lease_renew_loop(store, lease))
    if ready_file:
        # rtlint: disable=R001 one-shot startup marker write before serving
        with open(ready_file, "w") as f:
            json.dump({"address": addr, "epoch": epoch}, f)
    _ = lock  # pinned for process lifetime
    await asyncio.Event().wait()  # run forever


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--config-json", default="")
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument("--persist-dir", default=None)
    parser.add_argument("--standby", action="store_true",
                        help="wait for leadership over --persist-dir, then "
                             "take over serving at --host:--port")
    args = parser.parse_args()
    logging.basicConfig(
        level=os.environ.get("RT_LOG_LEVEL", args.log_level),
        format="%(asctime)s %(levelname)s control_store %(message)s",
    )
    if args.config_json:
        GLOBAL_CONFIG.load_overrides(args.config_json)
    try:
        asyncio.run(run_control_store(
            args.host, args.port, args.ready_file,
            persist_dir=args.persist_dir, standby=args.standby,
        ))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
