"""Object-recovery manager: the owner-side recovery plane.

Capability parity with the reference's object recovery manager (reference:
src/ray/core_worker/object_recovery_manager.h — RecoverObject pins a single
in-flight recovery per object, re-resolves locations, and falls back to
lineage re-execution via the task manager; task_manager.h lineage pinning).

What used to be ad-hoc reconstruction/retry logic scattered through
`core_worker.py` lives here as an explicit per-object state machine:

    LOCAL ──(read miss / death notice)──> FETCHING ──> LOCAL
      │                                      │
      └──(store copy lost)──> RECONSTRUCTING ┴──> LOCAL | FAILED

- single in-flight recovery per object: concurrent getters of one lost
  object coalesce onto ONE future (and one lineage re-execution per
  creating task — a multi-return task recovers all its returns at once);
- driven by AUTHORITATIVE failure notices: the core worker subscribes to
  the control store's node/worker death records (extending the
  worker-liveness records of the borrow reaper) and recovery triggers on
  the death pubsub — locations on a dead node are poisoned immediately, so
  readers fail over without waiting out a racy location-read timeout;
- FAILED is terminal per (object, budget): the reconstruction budget
  (`max_lineage_reconstructions`) is tracked per creating task.

Tests assert on `state_of()` / `wait_state()` instead of sleeping.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Dict, Optional

from ray_tpu_torch._private.aio import spawn
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectID

if TYPE_CHECKING:  # pragma: no cover — typing only
    from ray_tpu_torch._private.core_worker import CoreWorker
    from ray_tpu_torch._private.protocol import TaskSpec

logger = logging.getLogger(__name__)

# per-object recovery states
LOCAL = "LOCAL"                    # healthy (or never touched by recovery)
FETCHING = "FETCHING"              # a remote read / pull is in progress
RECONSTRUCTING = "RECONSTRUCTING"  # lineage re-execution in flight
FAILED = "FAILED"                  # unrecoverable (no lineage / budget spent)


class ObjectRecoveryManager:
    """Owner-side per-object recovery with lineage re-execution."""

    def __init__(self, cw: "CoreWorker"):
        self.cw = cw
        # lineage cache (reference: task_manager lineage pinning): completed
        # task specs whose shm-resident returns are still referenced, so a
        # lost object can be recomputed by resubmitting its creating task.
        # keepalive pins the arg ObjectRefs while the entry lives.
        self._lineage: Dict[bytes, tuple] = {}   # tid -> (spec, keepalive, n_rebuilt)
        self._lineage_returns: Dict[bytes, bytes] = {}  # return oid -> tid
        self._lineage_live: Dict[bytes, int] = {}       # tid -> live return count
        # single in-flight re-execution per creating task
        self._reconstructing: Dict[bytes, asyncio.Future] = {}
        # single in-flight recovery op per OBJECT: all waiters coalesce here
        self._object_ops: Dict[bytes, asyncio.Task] = {}
        # explicit per-object state machine + transition waiters
        self._states: Dict[bytes, str] = {}
        self._state_waiters: Dict[bytes, list] = {}
        # authoritative death notices seen: node id hex -> death reason
        # (surfaced in ObjectLostError so errors say WHY the copy vanished)
        self.dead_nodes: Dict[str, str] = {}
        # recovery-plane counters (chaos assertions key off these): a
        # graceful drain must produce replica failovers, NOT reconstructions
        self.stats: Dict[str, int] = {
            "lineage_reconstructions": 0,  # creating-task re-executions run
            "replica_failovers": 0,        # locations rewritten to replicas
            "locations_poisoned": 0,       # locations lost with a dead node
        }

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------

    def state_of(self, oid: bytes) -> str:
        return self._states.get(oid, LOCAL)

    def _set_state(self, oid: bytes, state: str) -> None:
        prev = self._states.get(oid, LOCAL)
        if state == LOCAL:
            self._states.pop(oid, None)
        else:
            self._states[oid] = state
        if prev != state:
            for fut in self._state_waiters.pop(oid, []):
                if not fut.done():
                    fut.set_result(state)

    async def wait_state_change(self, oid: bytes) -> str:
        """Await the object's next recovery-state transition (test hook:
        assert on state, not sleeps)."""
        fut = self.cw.loop.create_future()
        self._state_waiters.setdefault(oid, []).append(fut)
        return await fut

    def note_fetching(self, oid: bytes) -> None:
        """A getter started a remote read for this object."""
        if self._states.get(oid) not in (RECONSTRUCTING, FAILED):
            self._set_state(oid, FETCHING)

    def note_local(self, oid: bytes) -> None:
        """A read completed — the object is materializable again."""
        if self._states.get(oid) != RECONSTRUCTING:
            self._set_state(oid, LOCAL)

    # ------------------------------------------------------------------
    # lineage bookkeeping (reference: task_manager lineage pinning)
    # ------------------------------------------------------------------

    def _return_is_live(self, oid: bytes) -> bool:
        """An owned return is live while anyone (local or borrower) holds it."""
        rc = self.cw.ref_counter
        return (rc.local_counts.get(oid, 0) > 0
                or rc.borrower_counts.get(oid, 0) > 0)

    def record_lineage(self, spec: "TaskSpec", keepalive) -> None:
        """Cache the spec of a completed task whose returns live in a shm
        store (location-recorded) — those die with their node. Inline
        returns live in the owner's memory store and need no lineage.
        Already-freed returns (refcount zero) are not re-registered — a
        re-execution may have recreated them, but nothing can free them
        again, so tracking them would leak the lineage entry."""
        if spec.actor_id is not None or spec.is_streaming:
            return  # actor state is not replayable; streams not recovered
        if spec.max_retries <= 0:
            # max_retries=0 is an at-most-once contract (side-effecting
            # tasks); never silently re-run them (reference:
            # object_recovery_manager reconstructs only retryable tasks)
            return
        ms = self.cw.memory_store
        ret_oids = [
            oid.binary() for oid in spec.return_ids()
            if oid.binary() in ms.locations and self._return_is_live(oid.binary())
        ]
        if not ret_oids:
            return
        tid = spec.task_id.binary()
        prior = self._lineage.get(tid)
        self._lineage[tid] = (spec, keepalive, prior[2] if prior else 0)
        for ob in ret_oids:
            if self._lineage_returns.get(ob) != tid:
                self._lineage_returns[ob] = tid
                self._lineage_live[tid] = self._lineage_live.get(tid, 0) + 1
        cap = GLOBAL_CONFIG.get("lineage_cache_max_tasks")
        while len(self._lineage) > cap:
            old_tid = next(iter(self._lineage))
            old_spec, _, _ = self._lineage.pop(old_tid)
            self._lineage_live.pop(old_tid, None)
            for oid in old_spec.return_ids():
                self._lineage_returns.pop(oid.binary(), None)

    def drop_lineage_for(self, oid: bytes) -> None:
        tid = self._lineage_returns.pop(oid, None)
        self._states.pop(oid, None)
        if tid is None:
            return
        live = self._lineage_live.get(tid, 1) - 1
        if live <= 0:
            self._lineage_live.pop(tid, None)
            self._lineage.pop(tid, None)
        else:
            self._lineage_live[tid] = live

    def has_lineage(self, oid: bytes) -> bool:
        return self._lineage_returns.get(oid) in self._lineage

    # ------------------------------------------------------------------
    # authoritative failure notices (death pubsub)
    # ------------------------------------------------------------------

    def on_node_death(self, node_hex: str, daemon_address: str = "",
                      reason: str = "", expected: bool = False,
                      replicas: Optional[Dict[str, dict]] = None) -> None:
        """Control-store node-death notice: poison every owned location on
        the dead node so readers fail over IMMEDIATELY (no pull timeout to
        a dead daemon), and eagerly kick recovery for lost objects that
        have lineage and blocked waiters.

        An EXPECTED death (graceful drain / preemption) arrives with the
        drained node's replica map: locations are REWRITTEN to the live
        replica instead of poisoned, so readers fail over with zero lineage
        reconstructions — planned node removal is a non-event, not a
        recovery storm.

        This is the authoritative trigger the reference drives through the
        GCS node-failure pubsub — recovery no longer depends on a getter
        happening to trip over the stale location."""
        if node_hex in self.dead_nodes:
            return
        from ray_tpu_torch._private import flight_recorder

        flight_recorder.record(
            "recovery", "node_death", node=node_hex[:12], reason=reason,
            expected=expected, replicas=len(replicas or {}))
        self.dead_nodes[node_hex] = reason
        ms = self.cw.memory_store
        replicas = replicas or {}
        lost = []
        failed_over = 0
        for oid, loc in list(ms.locations.items()):
            if loc.get("node_id") != node_hex or loc.get("dead"):
                continue
            if oid in ms.objects:
                continue  # value also cached inline — nothing lost
            rep = replicas.get(ObjectID(oid).hex())
            if rep and rep.get("node_id") not in self.dead_nodes:
                # pre-replicated by the draining node: point readers at the
                # live copy — no poison, no reconstruction
                ms.set_location(oid, {
                    "node_id": rep["node_id"], "daemon": rep["daemon"],
                })
                failed_over += 1
                continue
            loc["dead"] = True  # poison: _read_store_object fails fast
            if reason:
                loc["death_reason"] = reason
            lost.append(oid)
        self.stats["replica_failovers"] += failed_over
        self.stats["locations_poisoned"] += len(lost)
        if failed_over:
            logger.info(
                "node %s expected-death notice: %d owned location(s) failed "
                "over to drain replicas (zero reconstructions)",
                node_hex[:8], failed_over)
        if not lost:
            return
        logger.info(
            "node %s death notice%s: %d owned object location(s) poisoned",
            node_hex[:8], " (expected)" if expected else "", len(lost))
        for oid in lost:
            if not self.has_lineage(oid):
                continue
            # eager recovery for objects someone is (or will be) waiting
            # on; the rest recover lazily on their next read — bounded work
            # per death, no thundering herd of re-executions
            if ms.futures.get(oid) or self._object_ops.get(oid) is not None:
                spawn(self.recover(oid, failed_node=node_hex))

    # ------------------------------------------------------------------
    # recovery (reference: object_recovery_manager.h RecoverObject)
    # ------------------------------------------------------------------

    async def recover(self, oid: bytes, failed_node: Optional[str] = None) -> bool:
        """Recover a lost owned object. Returns True if the object was (or
        already had been) recovered — the caller should retry the read —
        False if it has no usable lineage or the budget is spent.

        Single in-flight recovery per object: concurrent callers coalesce
        on one future. `failed_node` is the node the caller's read failed
        against; if the current location already points elsewhere, an
        earlier recovery refreshed it and no new re-execution is needed."""
        op = self._object_ops.get(oid)
        if op is None:
            from ray_tpu_torch._private import flight_recorder

            flight_recorder.record("recovery", "recover_object",
                                   object=oid.hex()[:12],
                                   failed_node=(failed_node or "")[:12])
            op = spawn(self._recover_once(oid, failed_node))
            self._object_ops[oid] = op
            op.add_done_callback(lambda _t: self._object_ops.pop(oid, None))
        # shield: one waiter's cancellation (caller deadline) must not
        # abort the shared recovery the other waiters coalesced onto
        return await asyncio.shield(op)

    async def _recover_once(self, oid: bytes,
                            failed_node: Optional[str]) -> bool:
        tid = self._lineage_returns.get(oid)
        if tid is None:
            self._set_state(oid, FAILED)
            return False
        pending = self._reconstructing.get(tid)
        if pending is not None:
            self._set_state(oid, RECONSTRUCTING)
            await asyncio.shield(pending)
            self._set_state(oid, LOCAL)
            return True
        ms = self.cw.memory_store
        if oid in ms.objects:
            self._set_state(oid, LOCAL)
            return True
        cur = ms.locations.get(oid)
        if (cur is not None and failed_node is not None
                and cur.get("node_id") != failed_node
                and not cur.get("dead")):
            # a finished recovery already relocated it to a live node
            self._set_state(oid, LOCAL)
            return True
        entry = self._lineage.get(tid)
        if entry is None:
            self._set_state(oid, FAILED)
            return False
        spec, keepalive, n_rebuilt = entry
        if n_rebuilt >= GLOBAL_CONFIG.get("max_lineage_reconstructions"):
            logger.warning(
                "object %s lost and lineage reconstruction budget spent",
                ObjectID(oid).hex(),
            )
            self._set_state(oid, FAILED)
            return False
        self._lineage[tid] = (spec, keepalive, n_rebuilt + 1)
        self.stats["lineage_reconstructions"] += 1
        done = self.cw.loop.create_future()
        self._reconstructing[tid] = done
        for roid in spec.return_ids():
            rb = roid.binary()
            if rb not in ms.objects and rb in ms.locations:
                self._set_state(rb, RECONSTRUCTING)
        logger.info(
            "reconstructing %s by resubmitting task %s (attempt %d)",
            ObjectID(oid).hex(), spec.name or spec.function_key, n_rebuilt + 1,
        )
        cw = self.cw
        try:
            # never resubmit onto a cached lease from the failed node: an
            # orphaned worker there may still accept the push and write the
            # "recovered" object into a store no daemon serves
            failed_loc = (cur or {}).get("daemon")
            if failed_loc:
                cw._drop_pooled_leases_from(failed_loc)
            # clear only locations lost with the failed node, so healthy
            # sibling copies stay readable; waiters block on the fresh run
            for roid in spec.return_ids():
                rb = roid.binary()
                loc = ms.locations.get(rb)
                if (rb not in ms.objects and loc is not None
                        and (failed_node is None or loc.get("dead")
                             or loc.get("node_id") == failed_node)):
                    ms.locations.pop(rb, None)
            # track the resubmission so ray_tpu_torch.cancel() can reach it
            atask = spawn(cw._submit_with_retries(spec, keepalive))
            cw._track_submission(spec, atask)
            try:
                await atask
            except asyncio.CancelledError:
                if not atask.cancelled():
                    raise  # this coroutine was cancelled, not the resubmission
                # cancelled resubmission already resolved the returns with
                # TaskCancelledError; the retrying reader surfaces it
            # the re-execution recreates every return; drop fresh copies of
            # returns nobody references anymore (they can never be freed by
            # refcount — their count is already zero)
            for roid in spec.return_ids():
                rb = roid.binary()
                if rb != oid and not self._return_is_live(rb):
                    spawn(cw.free_owned_object(roid))
        finally:
            self._reconstructing.pop(tid, None)
            if not done.done():
                done.set_result(True)
            for roid in spec.return_ids():
                rb = roid.binary()
                if self._states.get(rb) == RECONSTRUCTING:
                    self._set_state(rb, LOCAL)
        return True
