"""Job submission: run driver scripts on the cluster with status/log
tracking, multi-tenant quotas, and weighted fair-share admission.

The port's counterpart of ``ray_tpu/job_submission``. A job's
``resources={"GPU": n}`` leases its supervisor n cards (``num_gpus``), so
the entrypoint, a child of the supervisor, sees them; its driver joins the
port's cluster through ``RT_ADDRESS``.

Reference surface: python/ray/dashboard/modules/job/ — JobSubmissionClient
(sdk.py), JobManager (job_manager.py:57), JobSupervisor (job_supervisor.py:57
— one supervisor actor per job runs the entrypoint as a child process and
fate-shares), JobStatus lifecycle. Submission travels over the actor plane
instead of REST; the CLI (`ray_tpu_torch.scripts job ...`) wraps this client the
way `ray job submit` wraps the REST SDK.

Durability: the job table lives in the control store's persisted
`submitted_jobs` table (WAL/snapshot, replayed by the HA standby), so
status reads go straight to the store and records survive both manager
restarts and a control-store kill+takeover. The manager actor holds only
soft state (supervisor handles, the admission queue) and rebuilds it from
the table on restart.
"""

from __future__ import annotations

import io
import os
import time
import uuid
import zipfile
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.job_submission._manager import (
    JOB_MANAGER_NAME,
    JOBS_NAMESPACE,
    FairShareQueue,
    JobManager,
    job_cost,
)
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


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(path):
            for f in files:
                full = os.path.join(root, f)
                zf.write(full, os.path.relpath(full, path))
    return buf.getvalue()


def _store_call(method: str, payload: dict, timeout: float = 15.0) -> dict:
    from ray_tpu_torch._private.core_worker import get_core_worker

    cw = get_core_worker()
    return cw.run_sync(cw.control.call(method, payload), timeout)


class JobSubmissionClient:
    """Reference: python/ray/dashboard/modules/job/sdk.py
    JobSubmissionClient — same surface, actor-plane transport. Status and
    listing reads come straight from the durable store table (no manager
    round-trip); logs/stop go through the manager, which owns the
    supervisors."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address)
        self._manager = self._get_or_create_manager()

    @staticmethod
    def _get_or_create_manager():
        try:
            return ray_tpu_torch.get_actor(JOB_MANAGER_NAME, namespace=JOBS_NAMESPACE)
        except ValueError:
            pass
        try:
            # cluster singleton: prefer non-spot capacity (a reclaim wave
            # must not take the job control point with it; all-spot falls
            # back to unconstrained placement)
            from ray_tpu_torch._private.spot import anti_spot_placement

            return JobManager.options(
                name=JOB_MANAGER_NAME, namespace=JOBS_NAMESPACE,
                lifetime="detached",
                **anti_spot_placement("the JobManager"),
            ).remote()
        except Exception as e:  # noqa: BLE001 — name-collision race only
            if "already taken" not in str(e):
                raise
            # lost a create race with a concurrent client: use the winner's
            return ray_tpu_torch.get_actor(JOB_MANAGER_NAME, namespace=JOBS_NAMESPACE)

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   tenant: Optional[str] = None,
                   resources: Optional[Dict[str, float]] = None,
                   max_retries: int = 0) -> str:
        """Submit an entrypoint. `tenant` keys quota/fair-share accounting;
        `resources` is the job's cluster footprint (drives both admission
        quotas and autoscaler demand); `max_retries` allows resubmission
        after supervisor loss."""
        runtime_env = runtime_env or {}
        sid = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        wd = runtime_env.get("working_dir")
        wd_zip = _zip_dir(wd) if wd else None
        rec = {
            "submission_id": sid,
            "entrypoint": entrypoint,
            "env_vars": dict(runtime_env.get("env_vars", {})),
            "metadata": dict(metadata or {}),
            "max_retries": int(max_retries),
        }
        if tenant is not None:
            rec["tenant"] = tenant
        if resources is not None:
            rec["resources"] = dict(resources)
        return ray_tpu_torch.get(
            self._manager.submit.remote(rec, wd_zip), timeout=120)

    def get_job_info(self, submission_id: str) -> dict:
        reply = _store_call("job_get", {"submission_id": submission_id})
        rec = reply.get("job")
        if rec is None:
            raise ValueError(f"no job {submission_id!r}")
        return rec

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id)["status"]

    def get_job_logs(self, submission_id: str, offset: int = 0) -> str:
        return ray_tpu_torch.get(
            self._manager.logs.remote(submission_id, offset), timeout=60)

    def stop_job(self, submission_id: str) -> bool:
        return ray_tpu_torch.get(
            self._manager.stop.remote(submission_id), timeout=60)

    def list_jobs(self, offset: int = 0, limit: int = 100,
                  tenant: Optional[str] = None,
                  status: Optional[str] = None) -> List[dict]:
        payload = {"offset": offset, "limit": limit}
        if tenant is not None:
            payload["tenant"] = tenant
        if status is not None:
            payload["status"] = status
        return _store_call("job_list", payload).get("jobs", [])

    def set_tenant(self, tenant: str, weight: Optional[float] = None,
                   max_running: Optional[int] = None,
                   max_resources: Optional[Dict[str, float]] = None) -> dict:
        """Configure a tenant's fair-share weight and quota caps."""
        return ray_tpu_torch.get(
            self._manager.set_tenant.remote(
                tenant, weight, max_running, max_resources),
            timeout=60)

    def fair_share_stats(self) -> dict:
        return ray_tpu_torch.get(
            self._manager.fair_share_stats.remote(), timeout=60)

    def tail_job_logs(self, submission_id: str, poll_s: float = 1.0):
        """Generator of log increments until the job finishes. Each poll
        ships only the unseen suffix (offset-based) — re-fetching the whole
        growing file every tick would be O(n^2) bytes over the wire."""
        seen = 0
        while True:
            chunk = self.get_job_logs(submission_id, offset=seen)
            if chunk:
                yield chunk
                seen += len(chunk.encode("utf-8", "replace"))
            if self.get_job_status(submission_id) in TERMINAL:
                chunk = self.get_job_logs(submission_id, offset=seen)
                if chunk:
                    yield chunk
                return
            time.sleep(poll_s)


__all__ = [
    "FAILED",
    "FairShareQueue",
    "JobManager",
    "JobSubmissionClient",
    "JobSupervisor",
    "PENDING",
    "QUEUED",
    "RUNNING",
    "STOPPED",
    "SUCCEEDED",
    "TERMINAL",
    "job_cost",
]
