"""Always-on cluster flight recorder: a fixed-size, lock-light ring of
coarse runtime events in every process.

Reference shape: the task-event buffer (`_private/task_events.py` /
task_event_buffer.h) — bounded, drop-oldest, drained on demand — applied to
CONTROL-PLANE decisions instead of task lifecycles: state transitions, RPC
edge failures, lease grants, recovery/drain/resize decisions. The ring is
cheap enough to stay on in production (one deque.append per event; the
deque's maxlen eviction is O(1) and allocation-free), and it is the first
artifact pulled when something breaks:

- `dump()` returns the ring with process identity (role, pid, mode);
- every RPC-serving process answers `dump_flight_recorder`;
- `ray_tpu_torch.util.state.dump_flight_recorder()` collects the rings of every
  process in the cluster (driver, control store, daemons, workers);
- the chaos harness auto-dumps on scenario failure (tests/conftest.py);
- the node daemon and worker crash paths dump to a file before exiting.

Ring capacity comes from the `flight_recorder_ring_size` flag
(env `RAY_TPU_flight_recorder_ring_size`), resolved lazily at first use so
spawned processes pick up inherited overrides.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class FlightRecorder:
    """Bounded event ring. `record` is safe from any thread without taking
    a lock: deque.append with maxlen is a single atomic operation under the
    GIL, and the drop accounting tolerates benign races (it is telemetry,
    not a ledger)."""

    def __init__(self, capacity: int):
        self._ring: "collections.deque" = collections.deque(
            maxlen=max(16, int(capacity)))
        self._recorded = 0

    def record(self, category: str, event: str,
               detail: Optional[Dict[str, Any]] = None) -> None:
        self._ring.append((time.time(), category, event, detail))
        self._recorded += 1

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self) -> Dict[str, Any]:
        from ray_tpu_torch._private import chaos

        events = list(self._ring)
        return {
            "pid": os.getpid(),
            "role": chaos.role(),
            "ts": time.time(),
            "capacity": self._ring.maxlen,
            "recorded_total": self._recorded,
            "dropped": max(0, self._recorded - len(events)),
            "events": [
                {"ts": ts, "category": c, "event": e,
                 **({"detail": d} if d else {})}
                for ts, c, e, d in events
            ],
        }


_recorder: Optional[FlightRecorder] = None
_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _recorder
    rec = _recorder
    if rec is None:
        with _lock:
            if _recorder is None:
                try:
                    from ray_tpu_torch._private.config import GLOBAL_CONFIG

                    cap = GLOBAL_CONFIG.get("flight_recorder_ring_size")
                except Exception:  # noqa: BLE001 — config unavailable
                    cap = 2048
                _recorder = FlightRecorder(cap)
            rec = _recorder
    return rec


def record(category: str, event: str, **detail) -> None:
    """Record one coarse event into this process's ring. Never raises:
    the recorder must be safe to call from any failure path."""
    try:
        get_recorder().record(category, event, detail or None)
    except Exception:  # noqa: BLE001 — telemetry must never fail the caller
        pass


def dump() -> Dict[str, Any]:
    return get_recorder().dump()


def dump_to_file(path: str) -> Optional[str]:
    """Write this process's ring as JSONL (one header line + one line per
    event). Used by crash paths — swallows every error."""
    try:
        d = dump()
        events = d.pop("events")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps(d, default=str) + "\n")
            for ev in events:
                f.write(json.dumps(ev, default=str) + "\n")
        return path
    except Exception:  # noqa: BLE001 — crash paths must keep crashing cleanly
        return None


def crash_dump(reason: str) -> Optional[str]:
    """Dump the ring next to the process's logs on a fatal path. The
    destination dir comes from RT_LOG_DIR (set by the node daemon for its
    workers / by run_daemon for itself) falling back to the system temp
    dir; the filename carries role+pid so rings from one incident never
    overwrite each other."""
    import tempfile

    from ray_tpu_torch._private import chaos

    record("crash", reason)
    base = os.environ.get("RT_LOG_DIR")
    if not base:
        sess = os.environ.get("RT_SESSION_DIR")
        base = os.path.join(sess, "logs") if sess else tempfile.gettempdir()
    role = chaos.role().replace("/", "_")
    path = os.path.join(
        base, f"flight_{role}_{os.getpid()}_{int(time.time())}.jsonl")
    return dump_to_file(path)


def _reset_for_tests() -> None:
    global _recorder
    with _lock:
        _recorder = None


__all__ = ["FlightRecorder", "crash_dump", "dump", "dump_to_file",
           "get_recorder", "record"]
