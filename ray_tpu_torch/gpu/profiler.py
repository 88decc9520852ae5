"""``torch.profiler`` capture across the cluster.

The port's counterpart of ``ray_tpu/tpu/profiler.py``. Reference surface:
python/ray/util/tpu.py:1060 init_jax_profiler and the dashboard's capture
endpoint (dashboard/modules/reporter/jax_profile_manager.py:11). Capture is
a plain remote task pinned to the target node, which writes a chrome trace
(CPU activity, plus CUDA kernels and copies when the process sees a card)
into a directory on that node.

A profiler records the process it runs in. JAX's ``init_jax_profiler``
starts JAX's profiler server in a worker, and a client attaches to it to
trace that worker. torch has no such server, so ``init_profiler(port)``
listens on ``127.0.0.1:port`` in the calling process and runs
``capture_local`` there on each request. ``capture_on_node(...,
port=port)`` sends the request from the pinned task, so the trace is of
the process that called ``init_profiler`` (an actor running a train step,
say); without ``port`` it is of the task's own worker, as in JAX.
CUDA activity is recorded process-wide; CPU operators only on the thread
that runs the capture.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import List, Optional

import ray_tpu_torch

_capturing = threading.Event()
_server = None


def capturing() -> bool:
    """Whether a ``capture_local`` is recording in this process."""
    return _capturing.is_set()


def capture_local(logdir: str, duration_s: float = 2.0,
                  workload=None) -> str:
    """Trace this process for duration_s (or around `workload()` if
    given) into a chrome trace in `logdir`; returns `logdir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _capturing.set()
        try:
            if workload is not None:
                workload()
            else:
                time.sleep(duration_s)
        finally:
            _capturing.clear()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
    return logdir


def _files(logdir: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(logdir):
        out.extend(os.path.join(root, f) for f in files)
    return out


def init_profiler(port: int = 9999) -> int:
    """Serve captures of this process on 127.0.0.1:`port` (0: any free
    port): ``GET /capture?duration_s=2[&logdir=...]`` runs
    ``capture_local`` and answers ``{"logdir": ..., "files": [...]}``.
    Returns the port; a second call returns the first's."""
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import parse_qs, urlparse

    global _server
    if _server is not None:
        return _server.server_address[1]

    class _Capture(BaseHTTPRequestHandler):
        def do_GET(self):
            q = parse_qs(urlparse(self.path).query)
            logdir = (q.get("logdir", [""])[0]
                      or tempfile.mkdtemp(prefix="rt_torchprof_"))
            capture_local(logdir, float(q.get("duration_s", ["2.0"])[0]))
            body = json.dumps(
                {"logdir": logdir, "files": _files(logdir)}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    _server = HTTPServer(("127.0.0.1", port), _Capture)
    threading.Thread(target=_server.serve_forever, daemon=True,
                     name="rt-profiler").start()
    return _server.server_address[1]


@ray_tpu_torch.remote
def _capture_task(logdir: Optional[str], duration_s: float,
                  port: Optional[int] = None):
    """Runs on the target node's worker: captures its own process, or the
    one listening on `port` there. logdir=None creates a temp dir ON THE
    TARGET (a driver-side path would be meaningless on another node).
    Returns (logdir, files)."""
    if port is not None:
        import urllib.parse
        import urllib.request

        query = urllib.parse.urlencode(
            {"duration_s": duration_s, **({"logdir": logdir} if logdir
                                          else {})})
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/capture?{query}",
                timeout=duration_s + 120) as resp:
            reply = json.loads(resp.read())
        return reply["logdir"], reply["files"]
    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="rt_torchprof_")
    capture_local(logdir, duration_s)
    return logdir, _files(logdir)


def node_capture_task(node_id_hex: str):
    """The capture task pinned to `node_id_hex` (shared by capture_on_node
    and a dashboard's capture endpoint)."""
    from ray_tpu_torch._private.protocol import SchedulingStrategy

    return _capture_task.options(
        scheduling_strategy=SchedulingStrategy(
            kind="NODE_AFFINITY", node_id=node_id_hex, soft=False),
    )


def capture_on_node(node_id_hex: str, logdir: Optional[str] = None,
                    duration_s: float = 2.0,
                    port: Optional[int] = None) -> List[str]:
    """Capture a profile on a specific node: of the capturing task's own
    worker, or of the process there that called ``init_profiler(port)``.
    Returns trace file paths on that node."""
    _dir, files = ray_tpu_torch.get(
        node_capture_task(node_id_hex).remote(logdir, duration_s, port),
        timeout=duration_s + 120)
    return files


__all__ = ["capture_local", "capture_on_node", "capturing", "init_profiler",
           "node_capture_task"]
