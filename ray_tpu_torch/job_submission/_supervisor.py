"""Per-job supervisor actor: runs one job's entrypoint as a child driver
process and fate-shares with it in BOTH directions.

Reference: dashboard/modules/job/job_supervisor.py:57 — one detached
supervisor actor per job; the entrypoint runs as a subprocess whose driver
joins the cluster; the supervisor polls it and the JobManager polls the
supervisor. Fate-sharing: the child dying flips the supervisor's status
(manager-visible), and the supervisor dying kills the child's whole
process group (atexit for clean exits, PR_SET_PDEATHSIG for hard kills),
so no orphaned driver keeps computing against a job the table already
declared dead.
"""

from __future__ import annotations

import atexit
import io
import os
import signal
import subprocess
import tempfile
import time
import zipfile
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private import config as _config

# JobStatus (reference: job/common.py JobStatus)
QUEUED = "QUEUED"        # submitted, waiting for fair-share admission
PENDING = "PENDING"      # admitted: supervisor actor creation in flight
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"
TERMINAL = (SUCCEEDED, FAILED, STOPPED)


def _child_preexec():
    """Runs in the forked child before exec: new session (own process
    group, so stop() can killpg) + PR_SET_PDEATHSIG so the kernel SIGKILLs
    the driver if the supervisor dies without running atexit hooks.
    (pdeathsig arms against the forking THREAD's death — the actor
    executor thread — which only dies when the supervisor process does;
    atexit covers the graceful-exit paths the signal doesn't.)"""
    os.setsid()
    try:
        import ctypes

        PR_SET_PDEATHSIG = 1
        ctypes.CDLL(None, use_errno=True).prctl(
            PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    except Exception:  # noqa: BLE001 — non-Linux: atexit still covers us
        pass


@ray_tpu_torch.remote
class JobSupervisor:
    """Runs one job's entrypoint as a child process."""

    def __init__(self, submission_id: str, entrypoint: str,
                 env_vars: Dict[str, str],
                 working_dir_zip: Optional[bytes] = None):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self._status = RUNNING
        self._message = ""
        # the job's driver joins THIS cluster: a submission on a machine
        # where the worker env lost the control address would otherwise
        # run the driver against a silent "" address and fail obscurely
        # deep inside its own init — fail the submission loudly instead
        control_addr = os.environ.get("RT_CONTROL_ADDR", "")
        if not control_addr:
            raise RuntimeError(
                f"job {submission_id!r}: RT_CONTROL_ADDR is not set in the "
                "supervisor's environment — cannot point the driver at the "
                "cluster (refusing to run it against an empty RT_ADDRESS)")
        workdir = None
        if working_dir_zip:
            workdir = tempfile.mkdtemp(prefix=f"job_{submission_id}_")
            zipfile.ZipFile(io.BytesIO(working_dir_zip)).extractall(workdir)
        self._log_path = os.path.join(
            tempfile.gettempdir(), f"rt_job_{submission_id}.log")
        env = dict(os.environ)
        env.update(env_vars)
        env["RT_ADDRESS"] = control_addr
        log = open(self._log_path, "ab")
        try:
            self._proc = subprocess.Popen(
                entrypoint, shell=True, env=env, cwd=workdir,
                stdout=log, stderr=subprocess.STDOUT,
                preexec_fn=_child_preexec,
            )
        finally:
            # the child inherited the descriptor; keeping ours open leaks
            # one fd per job for the supervisor's lifetime
            log.close()
        atexit.register(self._kill_child)
        flight_recorder.record("job", "driver_spawned", sid=submission_id,
                               pid=self._proc.pid)
        self._report_running()

    def _report_running(self):
        """Stamp RUNNING (+ host/pid) into the control-store job table
        directly: the transition must not wait on the manager's next poll,
        and the record survives the manager."""
        try:
            from ray_tpu_torch._private.core_worker import get_core_worker

            cw = get_core_worker()
            cw.run_sync(cw.control.call("job_update", {
                "submission_id": self.submission_id,
                "fields": {"status": RUNNING, "message": "",
                           "start_time": time.time(),
                           "driver_pid": self._proc.pid,
                           "supervisor_node": cw.node_id_hex},
            }), 10)
        except Exception:  # noqa: BLE001 — the manager's poll still covers it
            pass

    def _kill_child(self):
        """Supervisor->child fate-share: SIGKILL the driver's process
        group on any supervisor exit path."""
        proc = getattr(self, "_proc", None)
        if proc is None or proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def pid(self) -> int:
        """Supervisor process pid (chaos harness: kill me and assert the
        driver dies with me)."""
        return os.getpid()

    def child_pid(self) -> int:
        return self._proc.pid

    def poll(self) -> dict:
        rc = self._proc.poll()
        if self._status == RUNNING and rc is not None:
            self._status = SUCCEEDED if rc == 0 else FAILED
            self._message = f"exit code {rc}"
        return {"status": self._status, "message": self._message}

    def logs(self, offset: int = 0) -> str:
        try:
            with open(self._log_path, "rb") as f:
                if offset:
                    f.seek(offset)
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

    def stop(self) -> bool:
        self.poll()
        if self._status in (SUCCEEDED, FAILED):
            return False  # terminal states never transition
        if self._proc.poll() is None:
            try:
                os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
            deadline = time.time() + _config.GLOBAL_CONFIG.get("job_stop_grace_s")
            while time.time() < deadline and self._proc.poll() is None:
                time.sleep(0.1)
            if self._proc.poll() is None:
                try:
                    os.killpg(os.getpgid(self._proc.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        self._status = STOPPED
        return True
