"""Simulated-node plane: the control-plane scale harness.

A SimNode is a protocol-faithful node-daemon SPEAKER with no worker pool, no
shm object store, and no subprocess: it registers, heartbeats (jittered, with
the availability-delta cursor), subscribes to the "nodes" channel with
seq-gap detection and cursor reconcile, grants/spills leases BY SCRIPT,
drains on notice, and dies on cue. One process stands up 500-1000 of them
against a single control store — the harness that measures register storms,
steady-state heartbeat load, pubsub fanout, reconcile cost, and lease
spillback convergence at node counts no laptop's worth of real daemons can
reach (ROADMAP item 5; reference: the fake_multi_node provider's role in the
reference's autoscaler tests, scaled from process-faking to protocol-faking).

What is FAKE: worker processes, the object store, task execution, physical
stats. What is REAL: every control-plane exchange — the RPC transport, the
register/heartbeat/subscribe/drain wire protocol, one TCP connection + one
(optional) listening server per node, exactly the per-node footprint the
control store sees from a real daemon.

Deterministic: node ids and jitter draws derive from (`simnode_seed`, index),
so a 1000-node scenario replays exactly.

Use in-process (`SimNodePlane`), or as a subprocess via
`python -m ray_tpu_torch._private.simnode` / `cluster_utils.Cluster.add_sim_nodes`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import signal
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import protocol as pb
from ray_tpu_torch._private.aio import spawn
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.protocol import NodeInfo, ResourceSet
from ray_tpu_torch.runtime.rpc import RpcClient, RpcServer

logger = logging.getLogger(__name__)


def _derived_node_id(seed: int, index: int) -> NodeID:
    if not seed:
        return NodeID.from_random()
    rnd = random.Random(f"simnode:{seed}:{index}")
    return NodeID(bytes(rnd.getrandbits(8) for _ in range(NodeID.SIZE)))


class SimNode:
    """One simulated node daemon. `serve=False` skips the listening server
    (registration/heartbeat/pubsub only — e.g. the WAL-churn test);
    `serve=True` nodes answer request_lease/ping like a real daemon."""

    def __init__(self, control_address: str, *, index: int = 0,
                 seed: int = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 serve: bool = True, heartbeat: bool = True,
                 watch_workers: bool = False,
                 host: str = "127.0.0.1"):
        self.index = index
        self.node_id = _derived_node_id(seed, index)
        self.control_address = control_address
        self.host = host
        self._serve = serve
        self._heartbeat = heartbeat
        self._rnd = random.Random(f"simnode-jitter:{seed}:{index}")
        self.total_resources = ResourceSet(dict(resources or {"CPU": 4.0}))
        self.available = ResourceSet(self.total_resources.to_dict())
        self.labels = dict(labels or {})
        self.labels.setdefault("simnode", "true")
        # scripted unmet lease demand (wire shapes) carried on heartbeats —
        # the autoscaler-bench path for "leases queued on this daemon"
        self.pending_shapes: List[dict] = []
        self.server: Optional[RpcServer] = None
        self.control: Optional[RpcClient] = None
        self.address = f"simnode-{self.node_id.hex()[:12]}:0"
        # membership view: node hex -> state (the subscriber-side aggregate
        # whose convergence the bench measures) + hex -> daemon address so
        # scripted spillback replies carry real targets
        self.membership: Dict[str, str] = {}
        self.peer_addresses: Dict[str, str] = {}
        # ALIVE-member count maintained incrementally: the plane's
        # convergence check reads this O(1) per node instead of scanning
        # 1000 views x 1000 entries per poll (which would saturate the
        # harness loop and perturb the measurement)
        self.alive_members = 0
        self._nodes_seq: Optional[int] = None
        self._node_table_version = -1
        # pre-gap cursor pinned at gap-detection time (the reconcile task
        # runs deferred; the gap-revealing notice's _v advances the cursor
        # past the shed window first); re-armed by mid-flight gaps
        self._reconcile_from: Optional[int] = None
        self._view_cursor = -1
        self._view_size = 0
        # counters the bench aggregates
        self.beats = 0
        self.notices = 0
        self.gaps_reconciled = 0
        self.leases_granted = 0
        self.leases_spilled = 0
        self.protocol_errors: List[str] = []
        self.state = "NEW"  # NEW | ALIVE | DRAINING | DEAD
        self._tasks: List[asyncio.Task] = []
        self._drain_task: Optional[asyncio.Task] = None
        self._reconcile_task: Optional[asyncio.Task] = None
        self._leases: Dict[bytes, ResourceSet] = {}
        # workers-channel subscriber half (the failover chaos harness):
        # exactly the core worker's machinery — _wv guard, pre-gap floor
        # pinning, get_workers_delta cursor reconciles — with counters for
        # the zero-loss/zero-dup assertions
        self._watch_workers = watch_workers
        self.worker_deaths: Dict[str, dict] = {}  # address -> notice
        self.worker_notices = 0          # raw stream deliveries
        self.worker_dup_applied = 0      # deaths applied more than once
        self._workers_seq: Optional[int] = None
        self._worker_table_version = -1
        self._workers_reconcile_from: Optional[int] = None
        self._workers_reconcile_task: Optional[asyncio.Task] = None
        # store-failover telemetry (also exported via store_ha metrics)
        self.store_reconnects = 0
        self.store_failovers = 0
        # preemption-plane telemetry: set when the store's view of US went
        # PREEMPTING (notice accepted), and stamps for the wave harness
        self.preempting = False
        self.notice_ts: Optional[float] = None
        self.gone_ts: Optional[float] = None
        self.graceful_exit: Optional[bool] = None

    # -- lifecycle ------------------------------------------------------

    async def start(self) -> None:
        delta_sync = GLOBAL_CONFIG.get("node_table_delta_sync")
        if self._serve:
            self.server = RpcServer(name=f"simnode-{self.node_id.hex()[:6]}")
            self.server.register_service(self)
            self.address = await self.server.start(self.host, 0)
        self.control = RpcClient(
            self.control_address, name=f"sim{self.index}->cs")
        await self.control.connect()
        self.control.subscribe_channel("nodes", self._on_nodes_message)
        # a transport reconnect (e.g. back-to-back call timeouts under
        # load) lands on a fresh conn_id: the store-side subscription is
        # gone until we re-subscribe — same protocol as the real daemon
        self.control.on_reconnect(self._resubscribe)
        sub = await self._call("subscribe", {"channel": "nodes"})
        if sub.get("seq") is not None:
            self._nodes_seq = sub["seq"]
        if self._watch_workers:
            self.control.subscribe_channel("workers",
                                           self._on_workers_message)
            wsub = await self._call("subscribe", {"channel": "workers"})
            if wsub.get("seq") is not None:
                self._workers_seq = wsub["seq"]
            # seed with the retained death records: deaths published before
            # our subscription never produced notices we saw
            await self._reconcile_workers(initial=True)
        info = NodeInfo(
            node_id=self.node_id,
            address=self.address,
            object_store_name=f"sim_{self.node_id.hex()[:12]}",
            resources=self.total_resources,
            labels=self.labels,
        )
        self._node_info = info
        reg = await self._call(
            "register_node",
            # lean registration (scale mode): the membership snapshot comes
            # from ONE delta pull below instead of every register reply in a
            # storm shipping the O(nodes) seed list
            {"node": info.to_wire(), "lean": bool(delta_sync)},
        )
        if reg.get("version") is not None:
            self._node_table_version = reg["version"]
        for nw in reg.get("nodes", []):
            self._apply_node_wire(nw)
        if delta_sync:
            await self._reconcile(initial=True)
        self.state = "ALIVE"
        self._apply_node_wire({"node_id": self.node_id.binary(),
                               "state": pb.NODE_ALIVE,
                               "address": self.address})
        if self._heartbeat:
            self._tasks.append(spawn(self._heartbeat_loop()))

    async def stop(self) -> None:
        self.state = "DEAD"
        for t in self._tasks:
            t.cancel()
        if (self._drain_task is not None
                and self._drain_task is not asyncio.current_task()):
            self._drain_task.cancel()
        if (self._reconcile_task is not None
                and not self._reconcile_task.done()):
            # an in-flight cursor reconcile racing shutdown would record a
            # bogus "client closed" protocol error
            self._reconcile_task.cancel()
        if (self._workers_reconcile_task is not None
                and not self._workers_reconcile_task.done()):
            self._workers_reconcile_task.cancel()
        if self.control is not None:
            await self.control.close()
        if self.server is not None:
            await self.server.stop()

    async def die(self) -> None:
        """Abrupt death: drop the control connection without unregistering —
        the health checker must notice (detection-latency measurements)."""
        if self.gone_ts is None:
            self.gone_ts = time.monotonic()
            self.graceful_exit = False
        await self.stop()

    async def drain(self, reason: str = pb.DRAIN_REASON_MANUAL,
                    deadline_s: float = 1.0) -> None:
        """Scripted graceful exit, the daemon's terminal-drain protocol
        minus the (nonexistent) workers/objects: file the drain, then
        unregister with an expected-death record."""
        self._drain_task = asyncio.current_task()  # notice path stands down
        self.state = "DRAINING"
        try:
            await self._call("drain_node", {
                "node_id": self.node_id.binary(), "reason": reason,
                "deadline_s": deadline_s,
            })
            await self._call("unregister_node", {
                "node_id": self.node_id.binary(), "expected": True,
                "reason": f"drained ({reason})",
            })
        finally:
            await self.stop()

    # -- control-store client half -------------------------------------

    async def _call(self, method: str, payload: dict) -> dict:
        try:
            return await self.control.call(method, payload, timeout=30)
        except Exception as e:  # noqa: BLE001 — the bench asserts on these
            if self.state != "DEAD":
                # calls failing BECAUSE this node is shutting down (a
                # reconcile racing stop's client close) aren't protocol bugs
                self.protocol_errors.append(
                    f"{method}: {type(e).__name__}: {e}")
            raise

    async def _resubscribe(self) -> None:
        """Reconnect handler: restore the store-side subscription, then
        reconcile if the channel moved (or the store restarted) while we
        were off the wire — mirrors NodeDaemon._subscribe_nodes(resync)."""
        if self.state == "DEAD":
            return
        # pin the PRE-reconnect cursor NOW: no notice from the new
        # connection can have been processed yet (the store-side
        # subscription doesn't exist until our subscribe lands), but the
        # moment it does, stream notices max-advance the cursor past the
        # missed window — and a reconcile pulling from the advanced cursor
        # (or a heartbeat version check comparing against it) would never
        # see the gap again
        pre_nodes = self._node_table_version
        try:
            sub = await self._call("subscribe", {"channel": "nodes"})
        except Exception:  # noqa: BLE001 — next reconnect retries
            return
        server_seq = sub.get("seq")
        # the ephemeral publish seq alone is NOT a sufficient same-stream
        # check: a failed-over store restarts its seq counters, and if it
        # published exactly as many notices as we had seen, the counters
        # COINCIDE while the content differs. The persisted version cursor
        # (resumed across failovers) breaks the tie.
        gap = (server_seq is not None and server_seq != self._nodes_seq) \
            or (sub.get("version") is not None
                and sub["version"] != pre_nodes)
        if gap:
            if (self._reconcile_from is None
                    or pre_nodes < self._reconcile_from):
                self._reconcile_from = pre_nodes
            self._spawn_reconcile()
        if server_seq is not None:
            self._nodes_seq = server_seq
        if self._watch_workers:
            pre_workers = self._worker_table_version
            try:
                wsub = await self._call("subscribe", {"channel": "workers"})
            except Exception:  # noqa: BLE001 — next reconnect retries
                return
            wseq = wsub.get("seq")
            if (wseq is not None and wseq != self._workers_seq) \
                    or (wsub.get("version") is not None
                        and wsub["version"] != pre_workers):
                gap = True
                if (self._workers_reconcile_from is None
                        or pre_workers < self._workers_reconcile_from):
                    self._workers_reconcile_from = pre_workers
                self._spawn_workers_reconcile()
            if wseq is not None:
                self._workers_seq = wseq
        # failover telemetry: outage duration + new-incarnation detection
        from ray_tpu_torch._private import store_ha

        outage = None
        if self.control.last_disconnect_ts is not None:
            outage = time.monotonic() - self.control.last_disconnect_ts
        self.store_reconnects += 1
        if gap:
            self.store_failovers += 1
        store_ha.record_store_reconnect("simnode", outage,
                                        new_incarnation=gap)

    async def _heartbeat_loop(self):
        period = (GLOBAL_CONFIG.get("heartbeat_period_s")
                  or GLOBAL_CONFIG.get("health_check_period_s"))
        jitter = GLOBAL_CONFIG.get("heartbeat_jitter")
        delta_sync = GLOBAL_CONFIG.get("node_table_delta_sync")
        # de-phase the fleet from the first beat: without an initial random
        # offset a register storm leaves every simnode beating in lockstep
        await asyncio.sleep(self._rnd.uniform(0, period))
        while self.state in ("ALIVE", "DRAINING"):
            try:
                await self.heartbeat_once(delta_sync)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — recorded by _call
                pass
            await asyncio.sleep(
                period * (1.0 + jitter * self._rnd.uniform(-1.0, 1.0)))

    async def heartbeat_once(self, delta_sync: Optional[bool] = None) -> dict:
        if delta_sync is None:
            delta_sync = GLOBAL_CONFIG.get("node_table_delta_sync")
        shape_cap = GLOBAL_CONFIG.get("heartbeat_pending_shapes_max")
        payload = {
            "node_id": self.node_id.binary(),
            "available": self.available.to_wire(),
            "stats": {"cpu_percent": 0.0, "mem_percent": 0.0,
                      "store_bytes": 0},
            "pending": len(self.pending_shapes),
            # harness users script human-unit shapes; heartbeats carry the
            # wire (fixed-point) format real daemons send
            "pending_resources": [ResourceSet(dict(s)).to_wire()
                                  for s in self.pending_shapes[:shape_cap]],
        }
        if delta_sync:
            payload["view_cursor"] = self._view_cursor
        reply = await self._call("heartbeat", payload)
        self.beats += 1
        if reply.get("unknown"):
            await self._call("register_node",
                             {"node": self._node_info.to_wire(),
                              "lean": bool(delta_sync)})
            return reply
        if "view_version" in reply:
            full = reply.get("view_full")
            if full is not None:
                self._view_size = len(full)
            else:
                self._view_size += len(reply.get("view_delta") or ())
                self._view_size -= len(reply.get("view_removed") or ())
            self._view_cursor = reply["view_version"]
            nv = reply.get("nodes_version")
            if nv is not None and nv != self._node_table_version:
                self._spawn_reconcile()
        else:
            self._view_size = len(reply.get("view", ()))
            # the real daemon merges the legacy reply's node list into its
            # peer table — that merge is also what heals a TRAILING pubsub
            # shed (a dropped notice with no successor reveals no seq gap)
            for nw in reply.get("nodes", []):
                self._apply_node_wire(nw)
        return reply

    def _on_nodes_message(self, message: dict):
        self.notices += 1
        seq = message.get("_seq")
        if seq is not None:
            if self._nodes_seq is not None and seq > self._nodes_seq + 1:
                # pin the PRE-gap cursor before this message's _v advances
                # it past the shed window (the reconcile runs deferred)
                if (self._reconcile_from is None
                        or self._node_table_version < self._reconcile_from):
                    self._reconcile_from = self._node_table_version
                self._spawn_reconcile()
            self._nodes_seq = max(self._nodes_seq or 0, seq)
        ver = message.get("_v")
        if ver is not None and ver <= self._node_table_version:
            # stale replay: the store's coalescing window can write a
            # notice AFTER the reconcile reply that already covered it —
            # applying it would resurrect superseded state (e.g. a DEAD
            # node back to DRAINING). A restarted store's lower counter is
            # handled by the reconcile path's authoritative reset.
            return
        self._apply_node_wire(message)

    def _apply_node_wire(self, wire: dict):
        ver = wire.get("_v")
        if ver is not None:
            # monotonic within a store incarnation; a restart's counter
            # reset is resolved by _reconcile's post-apply assignment
            self._node_table_version = max(self._node_table_version, ver)
        try:
            hexid = NodeID(wire["node_id"]).hex()
            state = wire.get("state", pb.NODE_ALIVE)
        except Exception as e:  # noqa: BLE001 — malformed notice is a bug
            self.protocol_errors.append(f"node wire: {e}")
            return
        old = self.membership.get(hexid)
        if state == pb.NODE_DEAD:
            self.membership.pop(hexid, None)
            self.peer_addresses.pop(hexid, None)
        else:
            self.membership[hexid] = state
            if wire.get("address"):
                self.peer_addresses[hexid] = wire["address"]
        self.alive_members += ((state == pb.NODE_ALIVE)
                               - (old == pb.NODE_ALIVE))
        if hexid == self.node_id.hex():
            if state == pb.NODE_PREEMPTING:
                # the store accepted our (or a chaos-injected) preemption
                # notice: we stay live — leases keep running, the drain
                # comes later from the control plane or the deadline
                self.preempting = True
            elif state == pb.NODE_DRAINING:
                deadline = wire.get("drain_deadline") or 0.0
                if deadline and self._drain_task is None:
                    # scripted self-drain on notice, like the daemon's
                    # terminal drain orchestration
                    self._drain_task = spawn(self._drain_on_notice(
                        wire.get("drain_reason", "notice")))

    async def _drain_on_notice(self, reason: str):
        self.state = "DRAINING"
        try:
            await self._call("unregister_node", {
                "node_id": self.node_id.binary(), "expected": True,
                "reason": f"drained ({reason})",
            })
        except Exception:  # noqa: BLE001 — recorded
            pass
        if self.gone_ts is None:
            self.gone_ts = time.monotonic()
            self.graceful_exit = True
        await self.stop()

    # -- preemption plane (the correlated-wave chaos harness) ----------

    async def report_preempt_notice(self, deadline_s: float) -> dict:
        """File this node's TTL'd preemption notice — exactly what the real
        daemon's PreemptionWatcher publishes on a GCE maintenance event."""
        self.notice_ts = time.monotonic()
        reply = await self._call("report_preemption_notice", {
            "node_id": self.node_id.binary(), "deadline_s": deadline_s,
        })
        if not reply.get("ok"):
            self.protocol_errors.append(
                f"report_preemption_notice refused: {reply}")
        return reply

    async def preempt_reactive(self, deadline_s: float) -> None:
        """Legacy reactive path: the notice triggers an immediate terminal
        self-drain (DRAINING for the whole window, death at the deadline) —
        the autoscaler only learns about the lost capacity from the death
        record. The bench's baseline arm."""
        self.notice_ts = time.monotonic()
        self._drain_task = asyncio.current_task()  # notice path stands down
        self.state = "DRAINING"
        try:
            await self._call("drain_node", {
                "node_id": self.node_id.binary(),
                "reason": pb.DRAIN_REASON_PREEMPTION,
                "deadline_s": deadline_s,
            })
        except Exception as e:  # noqa: BLE001 — recorded
            self.protocol_errors.append(f"reactive drain: {e}")
        await asyncio.sleep(deadline_s)
        try:
            await self._call("unregister_node", {
                "node_id": self.node_id.binary(), "expected": True,
                "reason": "preempted (reactive)",
            })
        except Exception:  # noqa: BLE001 — store may be failing over
            pass
        self.gone_ts = time.monotonic()
        self.graceful_exit = True
        await self.stop()

    def _spawn_reconcile(self) -> None:
        if self._reconcile_task is None or self._reconcile_task.done():
            self._reconcile_task = spawn(self._reconcile())

    async def _reconcile(self, initial: bool = False) -> None:
        if not initial:
            self.gaps_reconciled += 1
        while True:
            floor = self._reconcile_from
            self._reconcile_from = None
            pre = self._node_table_version  # cursor before this pass
            try:
                if GLOBAL_CONFIG.get("node_table_delta_sync"):
                    # the initial pull after a LEAN registration must be the
                    # full snapshot (cursor -1): nodes registered before our
                    # subscribe never produced notices we saw, and the
                    # post-register cursor would skip them. Gap reconciles
                    # pull from the PRE-gap floor, not the (already
                    # advanced) cursor.
                    cursor = -1 if initial else (
                        floor if floor is not None
                        else self._node_table_version)
                    reply = await self._call("get_nodes_delta",
                                             {"cursor": cursor})
                    wires = reply.get("updates") or reply.get("nodes") or []
                    if reply.get("full"):
                        self.membership.clear()
                        self.alive_members = 0
                    for nw in wires:
                        self._apply_node_wire(nw)
                    if reply.get("version") is not None:
                        # authoritative assignment AFTER the apply: this is
                        # what brings the cursor back DOWN when a restarted
                        # store's counter reset (max-only stream notices
                        # never would)
                        self._node_table_version = reply["version"]
                else:
                    reply = await self._call("get_all_nodes", {})
                    self.membership.clear()
                    self.alive_members = 0
                    for nw in reply.get("nodes", []):
                        self._apply_node_wire(nw)
            except Exception:  # noqa: BLE001 — store mid-failover: the
                # floor must survive the failure (stream notices will
                # advance the cursor past the missed window, making a
                # later from-cursor pull replay nothing), and the pull
                # must retry — nothing else re-arms it once the cursor
                # catches the server version
                if self.state == "DEAD":
                    return
                used = floor if floor is not None else pre
                if (self._reconcile_from is None
                        or used < self._reconcile_from):
                    self._reconcile_from = used
                await asyncio.sleep(0.5)
                continue
            if self._reconcile_from is None:
                return
            initial = False  # loop pass covers a mid-flight gap signal

    # -- workers-channel subscriber half (failover harness) ------------

    def _on_workers_message(self, message: dict):
        self.worker_notices += 1
        seq = message.get("_seq")
        if seq is not None:
            if self._workers_seq is not None and seq > self._workers_seq + 1:
                # pin the PRE-gap cursor before this message's _wv advances
                # it past the shed window (the reconcile runs deferred)
                if (self._workers_reconcile_from is None
                        or self._worker_table_version
                        < self._workers_reconcile_from):
                    self._workers_reconcile_from = self._worker_table_version
                self._spawn_workers_reconcile()
            self._workers_seq = max(self._workers_seq or 0, seq)
        ver = message.get("_wv")
        if ver is not None and ver <= self._worker_table_version:
            return  # stale replay; the _wv guard is the no-dup proof
        if ver is not None:
            self._worker_table_version = ver
        self._apply_worker_wire(message)

    def _apply_worker_wire(self, wire: dict):
        ver = wire.get("_wv")
        if ver is not None:
            self._worker_table_version = max(self._worker_table_version, ver)
        if not wire.get("dead"):
            # a "live" delta supersedes an earlier death (address recycled
            # + re-registered): clear it so a LEGITIMATE later re-death is
            # a fresh application, not a dup
            self.worker_deaths.pop(wire.get("address", ""), None)
            return
        addr = wire.get("address", "")
        if not addr:
            self.protocol_errors.append("worker wire: no address")
            return
        prev = self.worker_deaths.get(addr)
        if prev is not None:
            if prev.get("_wv") == wire.get("_wv"):
                return  # idempotent replay (full reconcile), not a dup
            # same address died "again" under a different version: the
            # store published one death twice — the bug class the failover
            # chaos test asserts never happens
            self.worker_dup_applied += 1
        self.worker_deaths[addr] = wire

    def _spawn_workers_reconcile(self) -> None:
        if (self._workers_reconcile_task is None
                or self._workers_reconcile_task.done()):
            self._workers_reconcile_task = spawn(self._reconcile_workers())

    async def _reconcile_workers(self, initial: bool = False) -> None:
        """Cursor reconcile of missed worker-death notices via
        get_workers_delta — the core worker's machinery, instrumented."""
        while True:
            floor = self._workers_reconcile_from
            self._workers_reconcile_from = None
            pre = self._worker_table_version
            cursor = -1 if initial else (
                floor if floor is not None else pre)
            try:
                reply = await self._call("get_workers_delta",
                                         {"cursor": cursor})
            except Exception:  # noqa: BLE001 — store mid-failover: re-arm
                # the floor (stream notices advance the cursor past the
                # missed window) and retry
                if self.state == "DEAD":
                    return  # shutdown race, not a protocol failure
                used = floor if floor is not None else pre
                if (self._workers_reconcile_from is None
                        or used < self._workers_reconcile_from):
                    self._workers_reconcile_from = used
                await asyncio.sleep(0.5)
                continue
            wires = reply.get("updates") or reply.get("workers") or []
            for w in wires:
                self._apply_worker_wire(w)
            if reply.get("version") is not None:
                # authoritative assignment AFTER the apply (restart reset)
                self._worker_table_version = reply["version"]
            if self._workers_reconcile_from is None:
                return
            initial = False

    # -- scripted daemon half (lease protocol) -------------------------

    async def rpc_ping(self, conn_id: int, payload) -> dict:
        return {"ok": True}

    async def rpc_node_info(self, conn_id: int, payload) -> dict:
        return {"node": self._node_info.to_wire(), "sim": True}

    async def rpc_request_lease(self, conn_id: int, payload: dict) -> dict:
        """Lease-grant-by-script: grant locally while scripted capacity
        lasts, else spill to a live peer from the membership view (seeded
        choice) — the same reply shapes a real daemon produces, so the
        spillback-convergence bench exercises the true client loop."""
        res = ResourceSet.from_wire(payload["resources"])
        hops = payload.get("hops", 0)
        if self.state == "DRAINING":
            return {"retry": True, "draining": True}
        if res.is_subset_of(self.available):
            self.available = self.available - res
            lease_id = bytes(self._rnd.getrandbits(8) for _ in range(16))
            self._leases[lease_id] = res
            self.leases_granted += 1
            return {"granted": True, "lease_id": lease_id,
                    "node_id": self.node_id.hex(),
                    "worker_address": f"sim-worker-{self.node_id.hex()[:8]}"}
        if hops < GLOBAL_CONFIG.get("lease_spillback_max_hops"):
            peers = sorted(
                h for h, st in self.membership.items()
                if st == pb.NODE_ALIVE and h != self.node_id.hex()
                and h in self.peer_addresses)
            if peers:
                self.leases_spilled += 1
                target = self._rnd.choice(peers)
                # the real daemon's reply shape: the client re-requests at
                # the spilled-to daemon's address with hops+1
                return {"spillback": self.peer_addresses[target],
                        "node_id": target}
        return {"infeasible": True}

    async def rpc_return_lease(self, conn_id: int, payload: dict) -> dict:
        res = self._leases.pop(payload.get("lease_id", b""), None)
        if res is not None:
            self.available = self.available + res
        return {"ok": True}

    async def rpc_kill_worker(self, conn_id: int, payload) -> dict:
        return {"ok": True}  # no workers to kill — scripted success

    async def rpc_drain(self, conn_id: int, payload) -> dict:
        payload = payload or {}
        await self.drain(payload.get("reason") or pb.DRAIN_REASON_MANUAL,
                         float(payload.get("deadline_s") or 1.0))
        return {"ok": True}


class SimNodePlane:
    """N SimNodes in this process, started with bounded concurrency (the
    register storm), plus the aggregate measurements the bench reads."""

    def __init__(self, control_address: str, count: Optional[int] = None,
                 *, seed: Optional[int] = None,
                 resources: Optional[Dict[str, float]] = None,
                 serve: bool = True, heartbeat: bool = True,
                 watch_workers: bool = False,
                 spawn_concurrency: int = 64,
                 spot_fraction: float = 0.0):
        self.count = count if count is not None \
            else GLOBAL_CONFIG.get("simnode_count")
        self.seed = seed if seed is not None \
            else GLOBAL_CONFIG.get("simnode_seed")
        # spot_fraction: the FIRST round(count*frac) nodes are labeled as
        # reclaimable spot capacity (deterministic by index, so wave tests
        # stay seed-stable across runs)
        n_spot = round(self.count * spot_fraction)
        self.nodes: List[SimNode] = [
            SimNode(control_address, index=i, seed=self.seed,
                    resources=resources,
                    labels={"spot": "true"} if i < n_spot else None,
                    serve=serve, heartbeat=heartbeat,
                    watch_workers=watch_workers)
            for i in range(self.count)
        ]
        self._spawn_concurrency = spawn_concurrency

    async def start(self) -> float:
        """Register storm: all nodes brought up with bounded concurrency.
        Returns the wall-clock seconds until every node is registered."""
        t0 = time.monotonic()
        sem = asyncio.Semaphore(self._spawn_concurrency)

        async def up(n: SimNode):
            async with sem:
                await n.start()

        await asyncio.gather(*(up(n) for n in self.nodes))
        return time.monotonic() - t0

    def alive(self) -> List[SimNode]:
        return [n for n in self.nodes if n.state == "ALIVE"]

    async def await_converged(self, expected: Optional[int] = None,
                              timeout: float = 60.0) -> float:
        """Wait until every live simnode's membership view holds exactly
        `expected` ALIVE nodes (default: the live plane size). Returns the
        seconds it took; raises TimeoutError with a histogram of view sizes
        otherwise — convergence IS the correctness claim at 1000 nodes."""
        deadline = time.monotonic() + timeout
        t0 = time.monotonic()
        expect = expected if expected is not None else len(self.alive())
        while True:
            sizes = [n.alive_members for n in self.alive()]
            if all(s == expect for s in sizes):
                return time.monotonic() - t0
            if time.monotonic() > deadline:
                from collections import Counter

                raise TimeoutError(
                    f"membership views never converged to {expect}: "
                    f"{dict(Counter(sizes))}")
            await asyncio.sleep(0.25)

    async def drain_wave(self, k: int, deadline_s: float = 1.0) -> List[SimNode]:
        """Gracefully drain the LAST k live nodes (scripted exits)."""
        victims = self.alive()[-k:]
        await asyncio.gather(*(n.drain(deadline_s=deadline_s)
                               for n in victims))
        return victims

    async def kill_wave(self, k: int) -> List[SimNode]:
        """Abruptly kill the last k live nodes (health checker's problem)."""
        victims = self.alive()[-k:]
        await asyncio.gather(*(n.die() for n in victims))
        return victims

    def spot_nodes(self) -> List[SimNode]:
        return [n for n in self.alive()
                if n.labels.get("spot") == "true"
                or n.labels.get("preemptible") == "true"]

    async def preempt_wave(self, frac: float, *, window_s: float = 0.2,
                           deadline_s: float = 1.5,
                           proactive: bool = True,
                           rng_seed: Optional[int] = None) -> dict:
        """Correlated spot-reclaim wave: a seeded draw picks
        `round(frac * len(spot fleet))` victims; each files its notice at a
        random offset inside `window_s` and the cloud kills it
        `deadline_s` later — unless (proactive mode) the control plane's
        drain already exited it gracefully. Reactive mode is the legacy
        baseline: the notice triggers an immediate terminal self-drain.

        Returns per-wave timings the bench/chaos tests assert on:
        first_notice/first_death (monotonic stamps), graceful vs killed
        victim counts, and the victim index list (seed-stable)."""
        r = random.Random(
            f"preempt-wave:{self.seed if rng_seed is None else rng_seed}")
        spots = self.spot_nodes()
        k = max(1, round(frac * len(spots))) if spots else 0
        victims = sorted(r.sample(spots, min(k, len(spots))),
                         key=lambda n: n.index)
        offsets = {n.index: r.uniform(0.0, window_s) for n in victims}

        async def reclaim(n: SimNode):
            await asyncio.sleep(offsets[n.index])
            if n.state != "ALIVE":
                return
            if not proactive:
                await n.preempt_reactive(deadline_s)
                return
            await n.report_preempt_notice(deadline_s)
            # the cloud's side of the contract: the host dies at the
            # deadline whether or not the drain finished. A graceful
            # store-driven exit (replacement registered -> drain ->
            # unregister) beats the reaper to it.
            remaining = (n.notice_ts or time.monotonic()) + deadline_s \
                - time.monotonic()
            await asyncio.sleep(max(0.0, remaining))
            if n.state not in ("DEAD",):
                await n.die()

        await asyncio.gather(*(reclaim(n) for n in victims))
        notice_ts = [n.notice_ts for n in victims if n.notice_ts is not None]
        death_ts = [n.gone_ts for n in victims
                    if n.gone_ts is not None and n.graceful_exit is False]
        return {
            "victims": [n.index for n in victims],
            "spot_fleet": len(spots),
            "first_notice": min(notice_ts) if notice_ts else None,
            "first_death": min(death_ts) if death_ts else None,
            "graceful": sum(1 for n in victims if n.graceful_exit),
            "killed": sum(1 for n in victims if n.graceful_exit is False),
        }

    async def stop(self) -> None:
        await asyncio.gather(*(n.stop() for n in self.nodes),
                             return_exceptions=True)

    def stats(self) -> dict:
        live = self.nodes
        return {
            "count": len(live),
            "alive": len(self.alive()),
            "beats": sum(n.beats for n in live),
            "notices": sum(n.notices for n in live),
            "push_frames": sum(
                n.control.push_frames for n in live if n.control),
            "push_messages": sum(
                n.control.push_messages for n in live if n.control),
            "bytes_received": sum(
                n.control.bytes_received for n in live if n.control),
            "gaps_reconciled": sum(n.gaps_reconciled for n in live),
            "leases_granted": sum(n.leases_granted for n in live),
            "leases_spilled": sum(n.leases_spilled for n in live),
            "worker_notices": sum(n.worker_notices for n in live),
            "worker_dup_applied": sum(n.worker_dup_applied for n in live),
            "store_reconnects": sum(n.store_reconnects for n in live),
            "store_failovers": sum(n.store_failovers for n in live),
            "preempting": sum(1 for n in live if n.preempting),
            "protocol_errors": [e for n in live for e in n.protocol_errors],
        }

    async def await_worker_deaths(self, expected: set,
                                  timeout: float = 60.0) -> float:
        """Wait until EVERY live watching simnode's death set equals
        `expected` (addresses) exactly — the zero-loss resubscribe claim.
        Returns seconds taken; raises TimeoutError with the miss histogram."""
        deadline = time.monotonic() + timeout
        t0 = time.monotonic()
        while True:
            watchers = [n for n in self.alive() if n._watch_workers]
            missing = {
                n.index: len(expected - set(n.worker_deaths))
                for n in watchers
                if expected - set(n.worker_deaths)
            }
            extra = {
                n.index: len(set(n.worker_deaths) - expected)
                for n in watchers
                if set(n.worker_deaths) - expected
            }
            if not missing and not extra:
                return time.monotonic() - t0
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"worker-death views never converged: "
                    f"{len(missing)} node(s) missing deaths "
                    f"(sample {dict(list(missing.items())[:3])}), "
                    f"{len(extra)} with extras")
            await asyncio.sleep(0.2)


async def _run_plane(args) -> None:
    plane = SimNodePlane(
        args.control_address, args.count or None,
        seed=args.seed if args.seed is not None else None,
        resources=json.loads(args.resources) if args.resources else None,
        serve=not args.no_serve,
    )
    elapsed = await plane.start()
    logger.info("simnode plane up: %d nodes in %.2fs", plane.count, elapsed)
    if args.ready_file:
        # rtlint: disable=R001 one-shot startup marker write after the plane is up
        with open(args.ready_file, "w") as f:
            json.dump({"count": plane.count,
                       "register_storm_s": elapsed,
                       "node_ids": [n.node_id.hex() for n in plane.nodes]},
                      f)
    stop = asyncio.Event()
    asyncio.get_running_loop().add_signal_handler(
        signal.SIGTERM, stop.set)
    await stop.wait()
    await plane.stop()


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--control-address", required=True)
    parser.add_argument("--count", type=int, default=0,
                        help="0 = the simnode_count config flag")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--resources", default="")
    parser.add_argument("--no-serve", action="store_true")
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--config-json", default="")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args()
    logging.basicConfig(
        level=os.environ.get("RT_LOG_LEVEL", args.log_level),
        format="%(asctime)s %(levelname)s simnode %(message)s",
    )
    if args.config_json:
        GLOBAL_CONFIG.load_overrides(args.config_json)
    try:
        asyncio.run(_run_plane(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
