"""Per-process task-event buffer, flushed to the control store.

Reference: src/ray/core_worker/profile_event.h:33 + task_event_buffer.h
(workers buffer ProfileEvents, flush to GcsTaskManager,
src/ray/gcs/gcs_task_manager.h) — `ray_tpu_torch.timeline()` renders the history
as Chrome-trace JSON the way `ray timeline` does
(python/ray/_private/state.py:1017).

Loss is ACCOUNTED: events trimmed past `task_event_buffer_max` increment
`rt_task_events_dropped_total` and the drop count rides every `drain()`
so the telemetry loop reports it to the control store (surfaced on the
dashboard scrape) — a silent gap in the task history is itself a bug
signal worth observing.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import GLOBAL_CONFIG


class TaskEventBuffer:
    def __init__(self):
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._dropped_pending = 0   # since the last drain()
        self.dropped_total = 0
        self._drop_counter = None
        self._drop_counter_gen = None
        # eager zero-registration: the dropped-total series exists on the
        # scrape (and the Grafana loss panel) before the first drop
        self._count_drops(0)

    def _count_drops(self, n: int):
        """Called under self._lock. The counter handle is re-resolved when
        the metric registry was reset (test isolation)."""
        self._dropped_pending += n
        self.dropped_total += n
        try:
            from ray_tpu_torch.util import metrics

            gen = metrics.registry_generation()
            if self._drop_counter is None or self._drop_counter_gen != gen:
                self._drop_counter = metrics.get_or_create_counter(
                    "rt_task_events_dropped_total",
                    "Task events trimmed from a full per-process buffer "
                    "before they could flush to the control store")
                self._drop_counter_gen = gen
            self._drop_counter.inc(n)
        except Exception:  # noqa: BLE001 — accounting must not fail record()
            pass

    def record(self, *, task_id: bytes, name: str, kind: str, event: str,
               worker_id: bytes, node_id: str, ts: Optional[float] = None,
               duration_s: Optional[float] = None,
               extra: Optional[Dict] = None):
        ev = {
            "task_id": task_id,
            "name": name,
            "kind": kind,            # NORMAL / ACTOR_CREATION / ACTOR_TASK
            "event": event,          # RUNNING / FINISHED / FAILED / SPAN
            "worker_id": worker_id,
            "node_id": node_id,
            "ts": ts if ts is not None else time.time(),
        }
        if duration_s is not None:
            ev["duration_s"] = duration_s
        if extra:
            ev.update(extra)
        cap = GLOBAL_CONFIG.get("task_event_buffer_max")
        with self._lock:
            self._events.append(ev)
            if len(self._events) > cap:
                n = len(self._events) - cap
                del self._events[:n]
                self._count_drops(n)

    def drain(self) -> Tuple[List[dict], int]:
        """Take the buffered events plus the number of events DROPPED since
        the previous drain — the flush reports both so the control store's
        history carries its own loss accounting."""
        with self._lock:
            out, self._events = self._events, []
            dropped, self._dropped_pending = self._dropped_pending, 0
            return out, dropped

    def requeue(self, events: List[dict], dropped: int = 0):
        """Put a drained-but-unflushed batch back (flush RPC failed) so a
        control-store blip doesn't lose the interval's events."""
        cap = GLOBAL_CONFIG.get("task_event_buffer_max")
        with self._lock:
            merged = events + self._events
            if len(merged) > cap:
                self._count_drops(len(merged) - cap)
            self._events = merged[-cap:]
            self._dropped_pending += dropped


_KIND_NAMES = {0: "normal", 1: "actor_creation", 2: "actor_task"}


def to_chrome_trace(events: List[dict]) -> List[dict]:
    """Chrome trace 'X' (complete) events. FINISHED/FAILED task records
    render as before (pid = node, tid = worker — matching `ray timeline`'s
    layout); SPAN records (execution spans, per-hop sub-spans, serve/data
    spans) render on the same worker rows so one traced sync call visibly
    splits into its hops and a serve request shows
    ingress→replica→batch→stream stitched by trace id."""
    trace = []
    for ev in events:
        event = ev.get("event")
        if event == "SPAN" and ev.get("trace_id"):
            dur = ev.get("duration_s") or 0.0
            trace.append({
                "name": ev["name"],
                "cat": "span",
                "ph": "X",
                "ts": ev["ts"] * 1e6,
                "dur": dur * 1e6,
                "pid": f"node:{ev.get('node_id', '')[:12]}",
                "tid": f"worker:{ev['worker_id'].hex()[:12]}",
                "args": {
                    "trace_id": ev["trace_id"],
                    "span_id": ev.get("span_id", ""),
                    "parent_span_id": ev.get("parent_span_id", ""),
                    "task_id": ev["task_id"].hex(),
                },
            })
            continue
        if event not in ("FINISHED", "FAILED"):
            continue
        dur = ev.get("duration_s", 0.0)
        trace.append({
            "name": ev["name"],
            "cat": _KIND_NAMES.get(ev["kind"], str(ev["kind"])),
            "ph": "X",
            "ts": (ev["ts"] - dur) * 1e6,
            "dur": dur * 1e6,
            "pid": f"node:{ev['node_id'][:12]}",
            "tid": f"worker:{ev['worker_id'].hex()[:12]}",
            "args": {
                "task_id": ev["task_id"].hex(),
                "status": ev["event"],
            },
        })
    return trace
