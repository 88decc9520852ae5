"""Train controller: the run loop driving worker groups to completion.

Reference: python/ray/train/v2/_internal/execution/controller/controller.py:105
— the controller owns the worker-group lifecycle: consult the scaling policy,
create the group, poll it, finalize checkpoints as rank shards land, and on
failure consult the failure policy, tear down, and re-create (resuming from
the latest finalized checkpoint).

Redesigned driver-side (a plain object run by Trainer.fit) rather than as a
detached actor: the framework's north-star path is a single driver owning
its gang, and driver-failure isolation can be layered on by running fit()
itself inside an actor. The port's copy of ``ray_tpu/train/_controller.py``:
JAX's TPU-slice gangs are NVLink-domain gangs here (``gpu/slice.py``), and
the live resize excludes them as JAX's excludes slices.

Elastic extension: for ElasticScalingPolicy runs the controller adds a
RESIZING state between RUNNING and the teardown path. A planned removal
(drain/preemption notice, observed on the node table and the "nodes"
pubsub) with enough survivors triggers a LIVE SHRINK — the gang pauses at
a step boundary, the doomed ranks' state shards re-shard across survivors
through the object plane, ranks renumber under a new generation, and
training resumes without ever tearing down. When the autoscaler restores
capacity, the symmetric REGROW spawns joiners that absorb shed shards.
Teardown + checkpoint-restore remains the fallback for everything
unplanned (and for train fns that never reach an elastic sync point).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.train._checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train._policies import (
    ElasticScalingPolicy,
    FailurePolicy,
    ScalingPolicy,
    usable_cluster_resources,
)
from ray_tpu_torch.train._worker_group import WorkerGroup, WorkerStatus

logger = logging.getLogger(__name__)


@dataclass
class TrainResult:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    best_checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)


class TrainController:
    def __init__(
        self,
        train_fn: Callable,
        train_config: Optional[dict],
        scaling_policy: ScalingPolicy,
        failure_policy: FailurePolicy,
        resources_per_worker: Dict[str, float],
        run_name: str,
        storage_path: str,
        checkpoint_manager: CheckpointManager,
        use_gpu_domain: bool = False,
        topology: str = "",
        accelerator_type: str = "",
        poll_interval_s: float = 0.2,
    ):
        self.train_fn = train_fn
        self.train_config = train_config
        self.scaling_policy = scaling_policy
        self.failure_policy = failure_policy
        self.resources_per_worker = resources_per_worker
        self.run_name = run_name
        self.storage_path = storage_path
        self.ckpt = checkpoint_manager
        self.use_gpu_domain = use_gpu_domain
        self.topology = topology
        self.accelerator_type = accelerator_type
        self.poll_interval_s = poll_interval_s
        self.failure_count = 0
        # planned-removal rejoins (drain/preemption): checkpoint-then-rejoin,
        # never charged against the failure policy's budget — a preempted
        # node is the dominant production "failure" and must be a non-event.
        # Bounded separately so a drain loop can't retry forever.
        self.drain_rejoins = 0
        self.max_drain_rejoins = int(
            GLOBAL_CONFIG.get("train_max_drain_rejoins"))
        # live resizes (elastic): shrink/regrow without teardown; bounded by
        # the same knob as drain rejoins (both are planned-removal budget)
        self.resizes = 0
        self.shrinks = 0
        self.regrows = 0
        self.state = "CREATED"
        self._group: Optional[WorkerGroup] = None
        # checkpoint steps reported but not yet finalized, keyed by
        # (gang generation, step) — staging dirs are generation-scoped so
        # a resize can purge the old layout without racing live writers
        self._pending_ckpt: Dict[tuple, Dict[str, Any]] = {}
        # resize trigger plumbing: the "nodes" pubsub listener flips the
        # dirty flag so a drain notice is acted on within one poll tick;
        # the periodic node-table read is the floor under notice loss
        self._nodes_dirty = threading.Event()
        self._next_node_check = 0.0
        self._no_resize_until = 0.0
        self._next_regrow = 0.0

    @staticmethod
    def _is_planned_removal(cause: Optional[str]) -> bool:
        """A worker lost to a graceful drain or preemption notice — the
        structured death reasons name the drain (\"node draining
        (preemption)\", \"drained (autoscaler)\") — is a planned rejoin,
        not a crash."""
        if not cause:
            return False
        c = cause.lower()
        return "drain" in c or "preempt" in c

    @staticmethod
    def _drain_in_progress(node_ids=None, terminal_only=False) -> bool:
        """Notice-driven planned-failure detection: a worker can die with a
        generic connection error before the structured death cause
        propagates, so also consult the node table — a DRAINING node, or a
        fresh expected-termination record, means the loss was planned.
        When the dead workers' nodes are known, only THOSE nodes count: an
        unrelated idle-node drain elsewhere in the cluster must not mask a
        genuine crash (which would silently bypass the failure budget).
        With terminal_only, a reversible (no-deadline) drain doesn't count
        either — only deadline-carrying drains kill workers, so callers
        with no node scoping available (group creation) use this to keep a
        routine idle-drain from masking a genuinely bad config."""
        wanted = {n for n in (node_ids or []) if n}
        fresh_s = float(GLOBAL_CONFIG.get("train_expected_death_fresh_s"))
        try:
            for n in ray_tpu_torch.nodes():
                if wanted and n.get("node_id") not in wanted:
                    continue
                if n.get("state") in ("DRAINING", "PREEMPTING") and (
                        not terminal_only or n.get("drain_deadline")):
                    return True
                death = n.get("death")
                if (death and death.get("expected")
                        and time.time() - death.get("ts", 0.0) < fresh_s):
                    return True
        except Exception:  # noqa: BLE001 — control store unreachable
            return False
        return False

    # -- helpers --------------------------------------------------------

    def _elastic_live(self) -> bool:
        # domain gangs are excluded: a domain placement group fate-shares
        # every bundle with every bundle's host, so an in-place resize
        # would be undone the moment the drained host's bundle releases
        # (and a joiner would land outside the NVLink domain) — a domain
        # reshape goes through checkpoint-restore, as JAX's slices do
        return (isinstance(self.scaling_policy, ElasticScalingPolicy)
                and bool(GLOBAL_CONFIG.get("train_live_resize"))
                and not self.use_gpu_domain)

    def _nodes(self) -> List[dict]:
        try:
            return ray_tpu_torch.nodes()
        except Exception:  # noqa: BLE001 — control store unreachable
            return []

    def _usable_resources(self) -> Dict[str, float]:
        """Capacity the group can actually target: DRAINING nodes and
        fresh expected-death records are excluded, so a post-drain
        (re)create never sizes for a width the shrunken cluster can't
        hold (and immediately resizes again)."""
        res = usable_cluster_resources(
            self._nodes(),
            float(GLOBAL_CONFIG.get("train_expected_death_fresh_s")))
        return res or {"CPU": 1.0}

    def _make_group(self) -> WorkerGroup:
        decision = self.scaling_policy.target_size(
            self._usable_resources(), self.resources_per_worker
        )
        logger.info("worker group size %d (%s)", decision.num_workers,
                    decision.reason)
        group = WorkerGroup(
            num_workers=decision.num_workers,
            resources_per_worker=self.resources_per_worker,
            run_name=self.run_name,
            storage_path=self.storage_path,
            run_dir=self.ckpt.run_dir,
            use_gpu_domain=self.use_gpu_domain,
            topology=self.topology,
            accelerator_type=self.accelerator_type,
            elastic=self._elastic_live(),
        )
        try:
            group.create(latest_checkpoint=self.ckpt.latest)
            group.start_training(self.train_fn, self.train_config)
        except BaseException:
            # a half-created group leaks its named sync actor, workers, and
            # placement group — the retry then collides on the name / starves
            # on resources and fails with a confusing actor-kill cause
            try:
                group.shutdown()
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
            raise
        return group

    def _ingest_reports(self, statuses: List[WorkerStatus],
                        result: TrainResult, world_size: int):
        """Collect metrics; finalize checkpoints once all rank shards landed."""
        for st in statuses:
            for rep in st.reports:
                result.metrics_history.append(rep["metrics"])
                if rep["metrics"]:
                    result.metrics = rep["metrics"]
                if "checkpoint_step" in rep:
                    key = (int(rep.get("generation", 0)),
                           rep["checkpoint_step"])
                    self._pending_ckpt[key] = rep["metrics"]
        for gen, step in sorted(self._pending_ckpt):
            ckpt = self.ckpt.finalize(
                step, self._pending_ckpt[(gen, step)],
                expected_ranks=world_size, generation=gen,
            )
            if ckpt is not None:
                del self._pending_ckpt[(gen, step)]
                result.checkpoint = ckpt
                logger.info("checkpoint finalized: %s", ckpt.path)
            elif self.ckpt.step_orphaned(step, gen):
                # reports queued before a resize commit can land AFTER the
                # purge (stashed doomed-rank reports, survivors' buffered
                # polls) and resurrect a step whose staging dir is gone —
                # shard writes complete before the report is queued, so
                # "neither staging nor final exists" can only mean purged
                del self._pending_ckpt[(gen, step)]

    # -- live resize triggers -------------------------------------------

    def _resize_trigger(self, group: WorkerGroup):
        """Decide whether the gang should resize NOW. Returns
        ("shrink", keep_indices, 0), ("grow", keep_indices, add) or None.

        Shrink: a worker sits on a node that is DRAINING with a deadline
        (preemption/autoscaler/manual removal) and enough workers survive
        to stay >= min_workers. The check runs BEFORE any worker dies —
        the whole point is to use the drain window to move shards while
        their holders are still alive.

        Grow: usable capacity (DRAINING and freshly-dead-expected nodes
        excluded) fits more workers than the gang currently has, bounded
        by the policy and rate-limited by the regrow cooldown."""
        if not self._elastic_live() or not group.elastic:
            return None
        now = time.monotonic()
        if now < self._no_resize_until:
            return None
        if not self._nodes_dirty.is_set() and now < self._next_node_check:
            return None
        self._nodes_dirty.clear()
        self._next_node_check = now + float(
            GLOBAL_CONFIG.get("train_node_watch_period_s"))
        nodes = self._nodes()
        if not nodes:
            return None
        by_id = {n["node_id"]: n for n in nodes}
        doomed = []
        for i, nid in enumerate(group.worker_nodes):
            rec = by_id.get(nid) if nid else None
            # PREEMPTING counts: a reclaim notice carries its deadline
            # before any drain starts — shrinking during the notice window
            # moves shards while their holders are certainly alive, and
            # the regrow lands on the autoscaler's pre-provisioned
            # replacement instead of waiting out a node boot
            if (rec is not None
                    and rec.get("state") in ("DRAINING", "PREEMPTING")
                    and rec.get("drain_deadline")):
                doomed.append(i)
        if doomed:
            keep = [i for i in range(len(group.workers)) if i not in doomed]
            if keep and len(keep) >= self.scaling_policy.min_workers:
                return ("shrink", keep, 0)
            return None  # below the floor: teardown path will handle it
        if now < self._next_regrow:
            return None
        fresh_s = float(GLOBAL_CONFIG.get("train_expected_death_fresh_s"))
        decision = self.scaling_policy.target_size(
            usable_cluster_resources(nodes, fresh_s),
            self.resources_per_worker)
        self._report_train_demand(decision.num_workers)
        add = decision.num_workers - group.num_workers
        if add > 0:
            self._next_regrow = now + float(
                GLOBAL_CONFIG.get("train_regrow_cooldown_s"))
            return ("grow", list(range(len(group.workers))), add)
        return None

    def _report_train_demand(self, target_now: int):
        """Elastic-train autoscaler hook: when the policy's max exceeds
        what usable capacity can host, push the missing width into the
        control store's demand aggregate (report_demand, TTL'd) so the
        demand-driven autoscaler provisions toward the run's ceiling
        instead of waiting for lease pileups. Empty shapes withdraw the
        entry once capacity catches up."""
        ceiling = int(getattr(self.scaling_policy, "max_workers", 0) or 0)
        missing = max(0, ceiling - target_now)
        try:
            from ray_tpu_torch._private.core_worker import get_core_worker

            cw = get_core_worker()
            ttl = 3.0 * float(
                GLOBAL_CONFIG.get("train_node_watch_period_s"))
            cw.run_sync(cw.control.call("report_demand", {
                "key": f"elastic_train:{self.run_name}",
                "shapes": [dict(self.resources_per_worker)] * missing,
                "ttl_s": ttl,
            }), 5)
        except Exception:  # noqa: BLE001 — demand hints must never
            pass           # perturb training

    def _try_live_resize(self, group: WorkerGroup, trigger) -> str:
        kind, keep, add = trigger
        if self.drain_rejoins + self.resizes >= self.max_drain_rejoins:
            logger.warning(
                "live %s skipped: planned-removal budget exhausted "
                "(%d rejoins + %d resizes)", kind, self.drain_rejoins,
                self.resizes)
            # same cooldown as a failed attempt: a still-DRAINING node
            # would otherwise re-trigger (and re-log) this every watch tick
            self._no_resize_until = time.monotonic() + float(
                GLOBAL_CONFIG.get("train_resize_park_timeout_s"))
            return "aborted"
        self.state = "RESIZING"
        try:
            verdict = group.live_resize(
                keep, add,
                park_timeout_s=float(
                    GLOBAL_CONFIG.get("train_resize_park_timeout_s")))
        finally:
            self.state = "RUNNING"
        if verdict == "ok":
            self.resizes += 1
            if kind == "shrink":
                self.shrinks += 1
            else:
                self.regrows += 1
            # in-flight staging shards were written under the OLD rank
            # layout; the resized gang re-checkpoints from its live state.
            # Generation-targeted: writers of the committed generation may
            # already be filling THEIR staging dirs (joiners train during
            # the survivor-commit window) and must not be raced.
            self._pending_ckpt.clear()
            self.ckpt.purge_staging(below_generation=group.generation)
            logger.info(
                "live %s committed: world=%d generation=%d", kind,
                group.num_workers, group.generation)
        else:
            # don't hammer prepare/park against a gang that can't resize
            # (non-elastic train fn, plan infeasible): one attempt per
            # park window
            self._no_resize_until = time.monotonic() + float(
                GLOBAL_CONFIG.get("train_resize_park_timeout_s"))
        return verdict

    # -- run loop -------------------------------------------------------

    def run(self) -> TrainResult:
        result = TrainResult()
        listener = None
        cw = None
        if self._elastic_live():
            try:
                from ray_tpu_torch._private.core_worker import get_core_worker

                cw = get_core_worker()

                def _notice(message, flag=self._nodes_dirty):
                    flag.set()

                cw.add_node_listener(_notice)
                listener = _notice
            except Exception:  # noqa: BLE001 — polling floor still works
                cw = None
        try:
            return self._run(result)
        finally:
            self.state = "DONE"
            if cw is not None and listener is not None:
                try:
                    cw.remove_node_listener(listener)
                except Exception:  # noqa: BLE001
                    pass

    def _run(self, result: TrainResult) -> TrainResult:
        while True:
            self.state = "SCHEDULING"
            try:
                self._group = self._make_group()
            except Exception as e:  # noqa: BLE001 — group creation failed
                if (self._drain_in_progress(terminal_only=True)
                        and self.drain_rejoins < self.max_drain_rejoins):
                    # creation raced a terminal drain (workers died on the
                    # leaving node mid-start): retry without spending the
                    # budget — reversible idle-drains kill nothing and must
                    # not mask a genuinely bad config
                    self.drain_rejoins += 1
                    time.sleep(0.5)
                    continue
                self.failure_count += 1
                if not self.failure_policy.decide(self.failure_count):
                    result.error = f"worker group creation failed: {e}"
                    return result
                time.sleep(min(2.0 ** self.failure_count * 0.2, 10.0))
                continue

            group = self._group
            failed = False
            planned = False
            self.state = "RUNNING"
            try:
                while True:
                    statuses = group.poll()
                    self._ingest_reports(statuses, result, group.num_workers)
                    dead = [s for s in statuses if not s.alive]
                    errored = [s for s in statuses if s.error and s.alive]
                    if dead or errored:
                        failed = True
                        cause = (dead or errored)[0].error
                        # only a LOST worker can be drain-caused: an
                        # application error in a live worker must charge the
                        # failure budget even while some node is draining
                        planned = bool(dead) and (
                            self._is_planned_removal(cause)
                            or self._drain_in_progress(
                                [s.node_id for s in dead]))
                        if planned:
                            logger.info(
                                "worker lost to planned node removal "
                                "(drain/preemption); rejoining from the "
                                "latest checkpoint: %s", cause)
                        else:
                            logger.warning("worker failure: %s", cause)
                        result.error = cause
                        break
                    if all(s.done for s in statuses):
                        # final drain: async checkpoint writes + last reports
                        group.flush_checkpoints()
                        self._ingest_reports(group.poll(), result,
                                             group.num_workers)
                        break
                    trigger = self._resize_trigger(group)
                    if trigger is not None:
                        verdict = self._try_live_resize(group, trigger)
                        if verdict == "ok":
                            continue  # resized in place; keep polling
                        if verdict == "failed":
                            # post-commit loss: the gang shape is undefined
                            # — planned teardown, resume from checkpoint
                            failed = True
                            planned = True
                            result.error = (
                                "live resize failed after commit; "
                                "falling back to checkpoint-restore")
                            break
                        # aborted: continue at the old width; if the drain
                        # kills workers anyway the normal path handles it
                    time.sleep(self.poll_interval_s)
            finally:
                group.shutdown()
                self._group = None

            if not failed:
                result.error = None
                result.best_checkpoint = self.ckpt.best
                result.checkpoint = self.ckpt.latest
                return result

            # drop partial staging shards from the failed incarnation: a
            # differently-sized restart would otherwise mix incarnations
            self._pending_ckpt.clear()
            self.ckpt.purge_staging()
            if planned:
                # drain-triggered rejoin: resume from the drain-window
                # checkpoint without spending the failure budget (bounded
                # separately so a pathological drain loop still terminates)
                self.drain_rejoins += 1
                if self.drain_rejoins > self.max_drain_rejoins:
                    result.error = (
                        f"too many drain rejoins ({self.drain_rejoins}); "
                        f"last cause: {result.error}")
                    return result
                logger.info(
                    "rejoining worker group after planned removal "
                    "(rejoin %d, failure budget untouched), resuming from %s",
                    self.drain_rejoins,
                    self.ckpt.latest.path if self.ckpt.latest else "scratch",
                )
                continue
            self.failure_count += 1
            if not self.failure_policy.decide(self.failure_count):
                return result
            logger.info(
                "restarting worker group (failure %d), resuming from %s",
                self.failure_count,
                self.ckpt.latest.path if self.ckpt.latest else "scratch",
            )
