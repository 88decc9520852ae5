"""Process orchestration: spawn the control store and node daemons.

Capability parity with the reference's node/services layer (reference:
python/ray/_private/node.py:1629 start_head_processes,
services.py:1523 start_gcs_server, :1610 start_raylet): head startup spawns the
control store and a node daemon as subprocesses with ready-file handshakes;
worker-node startup spawns a daemon pointed at an existing control store.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import GLOBAL_CONFIG


def _wait_ready(path: str, proc: subprocess.Popen, timeout: float = 30.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"process {proc.args} exited with {proc.returncode} during startup"
            )
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)
            except (json.JSONDecodeError, OSError):
                pass
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for ready file {path}")


def new_session_dir() -> str:
    # NOT "<tmp>/ray_tpu_torch": a directory named like the package next to a user's
    # script would shadow the real package as a namespace package.
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_sessions")
    session = os.path.join(
        base, f"session_{time.strftime('%Y%m%d-%H%M%S')}_{uuid.uuid4().hex[:6]}"
    )
    os.makedirs(os.path.join(session, "logs"), exist_ok=True)
    return session


def start_control_store(session_dir: str, port: int = 0) -> tuple:
    # a fresh control store = a fresh cluster: restart the spawn-ordered
    # daemon role labels so a scenario replayed in isolation draws the same
    # (seed, role) chaos streams as it did inside a longer run
    global _daemon_role_counter
    _daemon_role_counter = 0
    if GLOBAL_CONFIG.get("store_standby_enabled") \
            and not GLOBAL_CONFIG.get("control_store_persist"):
        # a standby can only take over state the primary actually persisted
        GLOBAL_CONFIG.apply_system_config({"control_store_persist": True})
    ready = os.path.join(session_dir, f"cs_ready_{uuid.uuid4().hex[:6]}.json")
    log = open(os.path.join(session_dir, "logs", "control_store.log"), "ab")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "ray_tpu_torch._private.control_store",
            "--port", str(port), "--ready-file", ready,
            "--config-json", GLOBAL_CONFIG.serialize_overrides(),
            "--persist-dir", os.path.join(session_dir, "control_store"),
        ],
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        env={**os.environ, "RT_CHAOS_ROLE": "control"},
    )
    log.close()
    info = _wait_ready(ready, proc)
    return proc, info["address"]


def start_standby_store(session_dir: str, address: str,
                        ready_file: str = None) -> subprocess.Popen:
    """Spawn a warm-standby control store for the primary serving at
    `address` over the session's shared persist dir. Returns immediately:
    the standby tails the WAL while waiting for leadership and writes its
    ready file (address/epoch/takeover timestamps) only at takeover."""
    host, port = address.rsplit(":", 1)
    if ready_file is None:
        ready_file = os.path.join(
            session_dir, f"cs_standby_ready_{uuid.uuid4().hex[:6]}.json")
    log = open(os.path.join(session_dir, "logs", "control_store_standby.log"),
               "ab")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "ray_tpu_torch._private.control_store",
            "--host", host, "--port", port, "--standby",
            "--ready-file", ready_file,
            "--config-json", GLOBAL_CONFIG.serialize_overrides(),
            "--persist-dir", os.path.join(session_dir, "control_store"),
        ],
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        env={**os.environ, "RT_CHAOS_ROLE": "control_standby"},
    )
    log.close()
    proc.standby_ready_file = ready_file
    return proc


# spawn-ordered chaos-role index for daemons started by THIS process: the
# chaos PRNG seeds from (seed, role), so stable spawn-order labels make a
# whole-cluster fault schedule replayable from one integer
_daemon_role_counter = 0


def start_node_daemon(
    control_address: str,
    session_dir: str,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    port: int = 0,
) -> tuple:
    global _daemon_role_counter
    _daemon_role_counter += 1
    ready = os.path.join(session_dir, f"nd_ready_{uuid.uuid4().hex[:6]}.json")
    log = open(
        os.path.join(session_dir, "logs", f"daemon_{uuid.uuid4().hex[:6]}.log"), "ab"
    )
    cmd = [
        sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
        "--control-address", control_address,
        "--session-dir", session_dir,
        "--port", str(port),
        "--ready-file", ready,
        "--config-json", GLOBAL_CONFIG.serialize_overrides(),
    ]
    if resources:
        cmd += ["--resources", json.dumps(resources)]
    if labels:
        cmd += ["--labels", json.dumps(labels)]
    proc = subprocess.Popen(
        cmd, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        env={**os.environ, "RT_CHAOS_ROLE": f"daemon{_daemon_role_counter}"},
    )
    log.close()
    info = _wait_ready(ready, proc)
    return proc, info


def kill_process(proc: subprocess.Popen, force: bool = False, timeout: float = 5.0):
    if proc.poll() is not None:
        return
    try:
        if force:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        else:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            try:
                proc.wait(timeout)
                return
            except subprocess.TimeoutExpired:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        proc.wait(timeout)
    except (ProcessLookupError, PermissionError):
        pass
