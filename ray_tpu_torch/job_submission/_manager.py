"""JobManager: the durable, multi-tenant job-plane brain.

Reference: dashboard/modules/job/job_manager.py:57 — but where the
reference keeps job records in the GCS KV, this manager keeps the whole
job table in the control store's persisted `submitted_jobs` table
(WAL-backed, surviving HA failover), and layers two things the stub
never had:

  * per-tenant quotas — caps on concurrently admitted jobs / resources
    per tenant key, so one tenant's burst can't occupy the cluster;
  * weighted fair-share admission — stride scheduling over tenants:
    each admission charges the tenant virtual time = job cost / weight,
    and the queued job of the lowest-vtime admissible tenant goes next,
    so completed-work share converges to the weight ratio under
    contention no matter how lopsided the submission rates are.

The manager actor itself holds only soft state (supervisor handles, the
admission queue, working-dir payloads): on restart it rebuilds from the
store table — QUEUED jobs re-enqueue, RUNNING jobs re-adopt their
supervisor actors by name, jobs whose supervisor is gone fail (or requeue
under their max_retries budget).
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private import config as _config
from ray_tpu_torch.job_submission._supervisor import (
    FAILED,
    PENDING,
    QUEUED,
    RUNNING,
    STOPPED,
    SUCCEEDED,
    TERMINAL,
    JobSupervisor,
)

logger = logging.getLogger(__name__)

JOB_MANAGER_NAME = "job-manager"
JOBS_NAMESPACE = "_jobs"
_TENANTS_KV_NS = "_job_plane"
_TENANTS_KV_KEY = b"tenants"
_FINAL_LOG_TAIL = 256 * 1024


def job_cost(resources: Dict[str, float]) -> float:
    """Scalar service cost charged to a tenant per admission: the sum of
    requested resource quantities (floor 1 so zero-resource jobs still
    consume schedule share)."""
    return max(1.0, float(sum(resources.values()))) if resources else 1.0


class FairShareQueue:
    """Weighted fair-share admission order over tenant keys (stride
    scheduling: virtual time advances by cost/weight per admission —
    reference: the classic WFQ virtual-clock formulation).

    Pure and synchronous so the convergence property is unit-testable
    without a cluster; the JobManager and the bench fleet driver both
    run this exact code.
    """

    def __init__(self, weight_of: Callable[[str], float]):
        self._weight_of = weight_of
        self._queues: Dict[str, collections.deque] = {}
        self._vtime: Dict[str, float] = {}

    def push(self, tenant: str, item, cost: float) -> None:
        q = self._queues.setdefault(tenant, collections.deque())
        if not q:
            # a tenant returning from idle starts at the active floor —
            # idle time must not bank credit that would let it monopolize
            # admissions until its stale vtime catches up
            active = [t for t, qq in self._queues.items() if qq and t != tenant]
            floor = min((self._vtime.get(t, 0.0) for t in active), default=0.0)
            self._vtime[tenant] = max(self._vtime.get(tenant, 0.0), floor)
        q.append((item, cost))

    def remove(self, tenant: str, item) -> bool:
        q = self._queues.get(tenant)
        if not q:
            return False
        for pair in q:
            if pair[0] == item:
                q.remove(pair)
                return True
        return False

    def backlog(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            return len(self._queues.get(tenant, ()))
        return sum(len(q) for q in self._queues.values())

    def vtime(self, tenant: str) -> float:
        return self._vtime.get(tenant, 0.0)

    def pop(self, can_admit: Callable[[str, object], bool]
            ) -> Optional[Tuple[str, object]]:
        """Next (tenant, item) in fair-share order among tenants whose
        HEAD job passes can_admit (quota headroom); None if nothing is
        admissible. Charges the admitted tenant's virtual time."""
        order = sorted(
            (t for t, q in self._queues.items() if q),
            key=lambda t: (self._vtime.get(t, 0.0), t))
        for t in order:
            item, cost = self._queues[t][0]
            if not can_admit(t, item):
                continue
            self._queues[t].popleft()
            self._vtime[t] = (self._vtime.get(t, 0.0)
                              + cost / max(self._weight_of(t), 1e-9))
            return t, item
        return None


@ray_tpu_torch.remote
class JobManager:
    """Tracks all submitted jobs; admits by fair share under quotas."""

    def __init__(self):
        self._lock = threading.RLock()
        # tenant -> {"weight", "max_running", "max_resources"|None}
        self._tenants: Dict[str, dict] = {}
        self._queue = FairShareQueue(self._weight_of)
        self._jobs: Dict[str, dict] = {}            # mirror of store records
        self._supervisors: Dict[str, object] = {}   # sid -> actor handle
        self._zips: Dict[str, Optional[bytes]] = {}
        self._final_logs: Dict[str, str] = {}
        self._poll_strikes: Dict[str, int] = {}
        # quota + fair-share accounting (tenant-keyed)
        self._running: Dict[str, set] = {}
        self._running_res: Dict[str, Dict[str, float]] = {}
        self._completed_cost: Dict[str, float] = {}
        self._load_tenants()
        self._recover()
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="job-manager-tick", daemon=True)
        self._thread.start()

    # -- control-store access ------------------------------------------

    @staticmethod
    def _store(method: str, payload: dict, timeout: float = 15.0) -> dict:
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        return cw.run_sync(cw.control.call(method, payload), timeout)

    def _write_job(self, rec: dict):
        """Merge-write into the durable table: job_update keeps fields the
        supervisor stamped store-side (start_time, driver_pid) that this
        mirror may not have seen; job_put only for brand-new records. A
        terminal-guard rejection means a racing writer (the supervisor, an
        old manager) finalized first — the read-back adopts its version."""
        sid = rec["submission_id"]
        reply = self._store("job_update",
                            {"submission_id": sid, "fields": dict(rec)})
        if not reply.get("ok") and not reply.get("terminal"):
            self._store("job_put", {"job": dict(rec)})
        stored = self._store("job_get", {"submission_id": sid}).get("job")
        if stored:
            rec.update(stored)
            self._jobs[sid] = rec

    # -- tenants --------------------------------------------------------

    def _weight_of(self, tenant: str) -> float:
        cfg = self._tenants.get(tenant)
        if cfg and cfg.get("weight") is not None:
            return float(cfg["weight"])
        return float(_config.GLOBAL_CONFIG.get("job_tenant_weight"))

    def _tenant_cfg(self, tenant: str) -> dict:
        cfg = dict(self._tenants.get(tenant, {}))
        cfg.setdefault("weight", _config.GLOBAL_CONFIG.get("job_tenant_weight"))
        cfg.setdefault("max_running",
                       _config.GLOBAL_CONFIG.get("job_tenant_max_running"))
        cfg.setdefault("max_resources", None)
        return cfg

    def set_tenant(self, tenant: str, weight: Optional[float] = None,
                   max_running: Optional[int] = None,
                   max_resources: Optional[Dict[str, float]] = None) -> dict:
        """Configure one tenant's quota/weight; persisted in the control
        store KV so it survives manager restarts AND store failovers."""
        with self._lock:
            cfg = self._tenants.setdefault(tenant, {})
            if weight is not None:
                cfg["weight"] = float(weight)
            if max_running is not None:
                cfg["max_running"] = int(max_running)
            if max_resources is not None:
                cfg["max_resources"] = dict(max_resources)
            try:
                self._store("kv_put", {
                    "ns": _TENANTS_KV_NS, "key": _TENANTS_KV_KEY,
                    "value": json.dumps(self._tenants).encode(),
                })
            except Exception:  # noqa: BLE001 — config survives in-memory
                logger.exception("persisting tenant config failed")
            return self._tenant_cfg(tenant)

    def _load_tenants(self):
        try:
            reply = self._store("kv_get", {"ns": _TENANTS_KV_NS,
                                           "key": _TENANTS_KV_KEY})
            if reply.get("value"):
                self._tenants = json.loads(bytes(reply["value"]).decode())
        except Exception:  # noqa: BLE001 — defaults apply
            logger.exception("loading tenant config failed")

    # -- recovery -------------------------------------------------------

    def _recover(self):
        """Rebuild soft state from the durable table (manager restart /
        adoption after a control-store failover)."""
        offset, records = 0, []
        while True:
            reply = self._store("job_list", {"offset": offset, "limit": 1000})
            records.extend(reply.get("jobs", []))
            offset += len(reply.get("jobs", []))
            if offset >= reply.get("total", 0) or not reply.get("jobs"):
                break
        for rec in sorted(records, key=lambda r: r.get("submit_time") or 0.0):
            sid = rec["submission_id"]
            self._jobs[sid] = rec
            status = rec.get("status")
            if status in TERMINAL:
                continue
            if status == QUEUED:
                self._queue.push(rec.get("tenant", ""), sid,
                                 job_cost(rec.get("resources") or {}))
                continue
            # PENDING/RUNNING: re-adopt the supervisor if it still exists
            try:
                handle = ray_tpu_torch.get_actor(f"job-supervisor:{sid}",
                                           namespace=JOBS_NAMESPACE)
                self._supervisors[sid] = handle
                self._charge(rec)
            except ValueError:
                self._on_supervisor_death(
                    rec, "supervisor lost across manager restart")
        flight_recorder.record("job", "manager_recovered",
                               jobs=len(records),
                               queued=self._queue.backlog())

    # -- quota accounting ----------------------------------------------

    def _charge(self, rec: dict):
        tenant = rec.get("tenant", "")
        self._running.setdefault(tenant, set()).add(rec["submission_id"])
        tot = self._running_res.setdefault(tenant, {})
        for k, v in (rec.get("resources") or {}).items():
            tot[k] = tot.get(k, 0.0) + float(v)

    def _release(self, rec: dict):
        tenant = rec.get("tenant", "")
        if rec["submission_id"] not in self._running.get(tenant, ()):
            return
        self._running[tenant].discard(rec["submission_id"])
        tot = self._running_res.get(tenant, {})
        for k, v in (rec.get("resources") or {}).items():
            tot[k] = tot.get(k, 0.0) - float(v)
            if tot[k] <= 1e-9:
                tot.pop(k, None)

    def _can_admit(self, tenant: str, sid: str) -> bool:
        cfg = self._tenant_cfg(tenant)
        if len(self._running.get(tenant, ())) >= int(cfg["max_running"]):
            return False
        cap = cfg.get("max_resources")
        if cap:
            rec = self._jobs.get(sid, {})
            tot = self._running_res.get(tenant, {})
            for k, limit in cap.items():
                want = tot.get(k, 0.0) + float(
                    (rec.get("resources") or {}).get(k, 0.0))
                if want > float(limit) + 1e-9:
                    return False
        return True

    # -- submission surface --------------------------------------------

    def submit(self, rec: dict, working_dir_zip: Optional[bytes]) -> str:
        sid = rec["submission_id"]
        with self._lock:
            if sid in self._jobs:
                raise ValueError(f"job {sid!r} already exists")
            existing = self._store("job_get", {"submission_id": sid})
            if existing.get("job") is not None:
                raise ValueError(f"job {sid!r} already exists")
            rec.setdefault("tenant", _config.GLOBAL_CONFIG.get("job_default_tenant"))
            rec.setdefault("resources", {"CPU": 1.0})
            rec.setdefault("max_retries", 0)
            rec.setdefault("retries_used", 0)
            rec["status"] = QUEUED
            rec["message"] = "waiting for admission"
            rec["submit_time"] = time.time()
            self._jobs[sid] = rec
            self._zips[sid] = working_dir_zip
            self._write_job(rec)
            self._queue.push(rec["tenant"], sid,
                             job_cost(rec["resources"]))
            self._admit_locked()
        return sid

    def _admit_locked(self):
        """Admit queued jobs in fair-share order while quotas allow."""
        while True:
            picked = self._queue.pop(self._can_admit)
            if picked is None:
                return
            tenant, sid = picked
            rec = self._jobs[sid]
            try:
                res = dict(rec.get("resources") or {})
                opts = {"name": f"job-supervisor:{sid}",
                        "namespace": JOBS_NAMESPACE, "lifetime": "detached"}
                if "CPU" in res:
                    opts["num_cpus"] = res.pop("CPU")
                if "GPU" in res:
                    opts["num_gpus"] = res.pop("GPU")
                if res:
                    opts["resources"] = res
                # a job's singleton supervisor prefers non-spot capacity —
                # losing it mid-job burns one of the job's retries for no
                # user fault (the job's own tasks still go wherever the
                # scheduler puts them; all-spot clusters fall back)
                from ray_tpu_torch._private.spot import anti_spot_placement

                opts.update(anti_spot_placement(f"job supervisor {sid}"))
                handle = JobSupervisor.options(**opts).remote(
                    sid, rec["entrypoint"], dict(rec.get("env_vars") or {}),
                    self._zips.get(sid))
            except Exception as e:  # noqa: BLE001 — spawn failed outright
                if "already taken" in str(e):
                    # a requeued job racing its previous attempt's reap:
                    # the detached name frees once the dead supervisor is
                    # marked ACTOR_DEAD — retry on the next tick
                    self._queue.push(tenant, sid,
                                     job_cost(rec.get("resources") or {}))
                    return
                rec.update(status=FAILED,
                           message=f"supervisor spawn failed: {e}",
                           end_time=time.time())
                self._write_job(rec)
                continue
            self._supervisors[sid] = handle
            self._poll_strikes.pop(sid, None)
            self._charge(rec)
            rec.update(status=PENDING, message="supervisor starting")
            self._write_job(rec)

    # -- the reconcile tick --------------------------------------------

    def _loop(self):
        period = _config.GLOBAL_CONFIG.get("job_poll_period_s")
        while not self._stop_evt.wait(period):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — keep reconciling
                logger.exception("job manager tick failed")

    def _tick(self):
        with self._lock:
            active = {sid: h for sid, h in self._supervisors.items()
                      if self._jobs.get(sid, {}).get("status")
                      in (PENDING, RUNNING)}
        if active:
            refs = {sid: h.poll.remote() for sid, h in active.items()}
            ray_tpu_torch.wait(list(refs.values()), num_returns=len(refs),
                         timeout=_config.GLOBAL_CONFIG.get(
                             "job_supervisor_poll_timeout_s"))
            for sid, ref in refs.items():
                try:
                    st = ray_tpu_torch.get(ref, timeout=0.5)
                except ray_tpu_torch.GetTimeoutError:
                    self._on_poll_timeout(sid)
                    continue
                except Exception as e:  # noqa: BLE001 — supervisor died
                    with self._lock:
                        rec = self._jobs.get(sid)
                        if rec is not None:
                            self._on_supervisor_death(
                                rec, f"supervisor died: {e}")
                    continue
                self._on_poll(sid, st)
        with self._lock:
            self._admit_locked()

    def _on_poll_timeout(self, sid: str):
        """A hung poll (node dying, store mid-failover): three strikes
        inside the poll budget before declaring the supervisor dead."""
        with self._lock:
            strikes = self._poll_strikes.get(sid, 0) + 1
            self._poll_strikes[sid] = strikes
            if strikes < 3:
                return
            rec = self._jobs.get(sid)
            if rec is not None:
                self._on_supervisor_death(
                    rec, "supervisor unresponsive (poll timeout)")

    def _on_poll(self, sid: str, st: dict):
        with self._lock:
            self._poll_strikes.pop(sid, None)
            rec = self._jobs.get(sid)
            if rec is None or rec.get("status") in TERMINAL:
                return
            if st["status"] == RUNNING:
                if rec.get("status") == PENDING:
                    # normally the supervisor stamped RUNNING (and
                    # start_time) itself; mirror what the poll proved and
                    # only backfill start_time if the stamp never landed
                    rec.update(status=RUNNING, message="")
                    self._write_job(rec)
                    if "start_time" not in rec:
                        rec["start_time"] = time.time()
                        self._write_job(rec)
                return
            if st["status"] in TERMINAL:
                self._finalize(rec, st["status"], st.get("message", ""))

    def _finalize(self, rec: dict, status: str, message: str):
        """Terminal transition: final log capture, table write, quota
        release, completed-work accounting, supervisor teardown."""
        sid = rec["submission_id"]
        handle = self._supervisors.pop(sid, None)
        if handle is not None and sid not in self._final_logs:
            try:
                logs = ray_tpu_torch.get(handle.logs.remote(), timeout=10)
                self._final_logs[sid] = logs[-_FINAL_LOG_TAIL:]
            except Exception:  # noqa: BLE001 — logs are best-effort
                pass
        rec.update(status=status, message=message, end_time=time.time())
        self._write_job(rec)
        self._release(rec)
        tenant = rec.get("tenant", "")
        if status in (SUCCEEDED, STOPPED) or rec.get("start_time"):
            # work was performed: charge the tenant's completed share
            self._completed_cost[tenant] = (
                self._completed_cost.get(tenant, 0.0)
                + job_cost(rec.get("resources") or {}))
        if handle is not None:
            try:
                # detached supervisors outlive every driver: reap them or
                # each finished job leaks an idle actor + its resources
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass
        self._zips.pop(sid, None)
        flight_recorder.record("job", "finalized", sid=sid, status=status)

    def _on_supervisor_death(self, rec: dict, cause: str):
        """Supervisor gone mid-flight: release quota, then retry under
        the job's max_retries budget or fail with the surfaced cause."""
        sid = rec["submission_id"]
        self._supervisors.pop(sid, None)
        self._poll_strikes.pop(sid, None)
        self._release(rec)
        retries_used = int(rec.get("retries_used", 0))
        if retries_used < int(rec.get("max_retries", 0)):
            rec.update(status=QUEUED, retries_used=retries_used + 1,
                       message=f"requeued (attempt {retries_used + 2}): "
                               f"{cause}")
            rec.pop("start_time", None)
            self._write_job(rec)
            self._queue.push(rec.get("tenant", ""), sid,
                             job_cost(rec.get("resources") or {}))
            flight_recorder.record("job", "requeued", sid=sid, cause=cause)
        else:
            self._finalize(rec, FAILED, cause)

    # -- query/control surface -----------------------------------------

    def status(self, submission_id: str) -> dict:
        with self._lock:
            rec = self._jobs.get(submission_id)
        if rec is None:
            reply = self._store("job_get", {"submission_id": submission_id})
            rec = reply.get("job")
            if rec is None:
                raise ValueError(f"no job {submission_id!r}")
        return {"status": rec.get("status"),
                "message": rec.get("message", ""), **rec}

    def logs(self, submission_id: str, offset: int = 0) -> str:
        with self._lock:
            handle = self._supervisors.get(submission_id)
            final = self._final_logs.get(submission_id)
        if handle is not None:
            try:
                return ray_tpu_torch.get(handle.logs.remote(offset), timeout=30)
            except Exception:  # noqa: BLE001 — fall through to the capture
                pass
        if final is not None:
            return final[offset:]
        return ""

    def stop(self, submission_id: str) -> bool:
        with self._lock:
            rec = self._jobs.get(submission_id)
            if rec is None:
                raise ValueError(f"no job {submission_id!r}")
            if rec.get("status") in (SUCCEEDED, FAILED):
                return False  # terminal states never transition
            if rec.get("status") == QUEUED:
                self._queue.remove(rec.get("tenant", ""), submission_id)
                rec.update(status=STOPPED, message="stopped by user",
                           end_time=time.time())
                self._write_job(rec)
                return True
            handle = self._supervisors.get(submission_id)
        if handle is not None:
            try:
                ray_tpu_torch.get(handle.stop.remote(), timeout=30)
            except Exception:  # noqa: BLE001 — dying anyway
                pass
        with self._lock:
            rec = self._jobs.get(submission_id)
            if rec is not None and rec.get("status") not in TERMINAL:
                self._finalize(rec, STOPPED, "stopped by user")
        return True

    def list(self, offset: int = 0, limit: int = 100,
             tenant: Optional[str] = None) -> List[dict]:
        reply = self._store("job_list", {
            "offset": offset, "limit": limit,
            **({"tenant": tenant} if tenant is not None else {}),
        })
        return reply.get("jobs", [])

    def fair_share_stats(self) -> dict:
        """Per-tenant accounting for the fairness proof: completed work,
        running/queued depth, configured weight, virtual time."""
        with self._lock:
            tenants = (set(self._tenants) | set(self._running)
                       | set(self._completed_cost)
                       | {r.get("tenant", "") for r in self._jobs.values()})
            return {
                t: {
                    "weight": self._weight_of(t),
                    "completed_cost": self._completed_cost.get(t, 0.0),
                    "running": len(self._running.get(t, ())),
                    "queued": self._queue.backlog(t),
                    "vtime": self._queue.vtime(t),
                }
                for t in tenants if t
            }
