"""Distributed tracing: spans propagated through task specs, opt-in.

Reference surface: python/ray/util/tracing/tracing_helper.py
(_DictPropagator.inject/extract :181 — trace context carried inside the
TaskSpec; method wrappers creating spans around submission and execution;
opt-in via _enable_tracing :98).

Redesign: tracing is a first-class field of the framework's TaskSpec
(`trace_ctx`) rather than a monkey-patched wrapper layer. When enabled:

- the submitting side stamps {trace_id, parent_span_id} from the caller's
  current span context into every outgoing spec. A ROOT submission (no
  current span) stamps the constant DERIVE_CTX sentinel instead of minting
  a random trace id: the executing side derives the trace id from the task
  id. The sentinel is per-task-invariant, so the native fast path's
  interned spec templates stay valid with tracing ON — per-hop telemetry
  must not silently disable the submission engine it is measuring;
- the executing side opens a span around the user function (streaming
  tasks included: the span covers generator iteration), installs it as
  the current context (so nested submissions chain), and records the
  finished span into the task-event plane — `list_spans()` reads them
  back with trace/span/parent ids intact. An OTel exporter can be layered
  by draining `list_spans()`; the ids are W3C-shaped for that purpose;
- `span(name)` opens an explicit span in ANY process (serve ingress,
  replica admission, batch flushes, data executor segments) recorded
  through the local core worker's task-event buffer, chaining to the
  current span so a serve request stitches ingress→replica→batch→stream
  into one trace.

Enablement: the `tracing_enabled` config flag (env
`RAY_TPU_tracing_enabled`, or `ray_tpu_torch.init(system_config=...)` which
spawned processes inherit); the legacy `RT_TRACING_ENABLED` env var is
kept as an override (read when this module loads) and `enable_tracing()`
sets it for child processes.

Local spans. Every finished `span()` / manual span also lands in a bounded
process-local buffer (`local_spans()`), on `time.perf_counter_ns()`, with
its thread's name, its parent and its attributes (integers and short
strings). A span is recorded while the flag is on OR while a
`torch.profiler` records anywhere in the process (checked through
`sys.modules`: this module never imports torch), so any profiler capture
gets the program's spans with the flag off; task-spec propagation
(`inject_context`) and the task-event plane stay on the flag alone. While
a profiler records on the span's own thread, the span also enters
`torch.profiler.record_function(name)`, so it appears in the Chrome trace;
spans of other threads reach the trace's clock through the buffer. While
recording, garbage collections are spans too (`host.gc`, with
`generation` and `collected`). With recording off a span costs one cached
check; a site that opens several spans checks once (`recording()`) and
passes the answer as `on=`.

W3C-style ids (32-hex trace ids, 16-hex span ids) keep the contexts
interoperable with OTel propagators.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import gc
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

_ENABLED = os.environ.get("RT_TRACING_ENABLED", "") in ("1", "true")
_current_span: "contextvars.ContextVar[Optional[dict]]" = (
    contextvars.ContextVar("rt_trace_span", default=None))

# Root-submission sentinel: carried by IDENTITY on the hot path (the fast
# lane compares `spec.trace_ctx is DERIVE_CTX`) and by VALUE on the wire
# (a {"d": 1} dict with no trace_id). Never mutate it.
DERIVE_CTX: Dict[str, int] = {"d": 1}


def enable_tracing() -> None:
    """Turn on span propagation + recording in THIS process. Worker
    processes inherit the setting through the RT_TRACING_ENABLED env var
    (set it in runtime_env env_vars, or before ray_tpu_torch.init on the
    driver — init propagates the driver's env to spawned daemons). The
    `tracing_enabled` system_config flag is the first-class switch."""
    global _ENABLED
    _ENABLED = True
    os.environ["RT_TRACING_ENABLED"] = "1"


_CONFIG = None


def tracing_enabled() -> bool:
    # hot path: called by inject_context on every .remote(); the config
    # registry reference is cached module-level and GLOBAL_CONFIG.get is a
    # memoized dict hit, so the tracing-off cost stays at two lookups
    if _ENABLED:
        return True
    global _CONFIG
    if _CONFIG is None:
        try:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            _CONFIG = GLOBAL_CONFIG
        except Exception:  # noqa: BLE001 — config gone mid-teardown
            return False
    try:
        return bool(_CONFIG.get("tracing_enabled"))
    except Exception:  # noqa: BLE001 — registry mid-reset
        return False


# -- the local buffer ---------------------------------------------------------

LOCAL_CAPACITY = 1 << 14   # ~0.7 KB a span: ~11 MB when full
_local: "collections.deque[dict]" = collections.deque(maxlen=LOCAL_CAPACITY)
_local_dropped = 0
_gc_hooked = False
_gc_start: Optional[int] = None
_flag_seen = False  # the flag as recording() last read it (for _on_gc)


def _profiling() -> bool:
    """A torch.profiler records somewhere in this process (the
    process-global flag torch keeps; torch is never imported here)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def recording() -> bool:
    """Whether spans are recorded now: the `tracing_enabled` flag, or a
    profiler recording in this process."""
    global _flag_seen
    _flag_seen = tracing_enabled()
    if _flag_seen or _profiling():
        if not _gc_hooked:
            _hook_gc()
        return True
    return False


def _annotate(name: str):
    """A ``record_function(name)`` to enter when a profiler records on
    THIS thread (torch's thread-local check), else None."""
    if not _profiling():
        return None
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    return torch.autograd.profiler.record_function(name)


def _keep(sp: dict, manual: bool = False) -> None:
    global _local_dropped
    if len(_local) == LOCAL_CAPACITY:
        _local_dropped += 1   # the append below evicts the oldest
    _local.append({
        "name": sp["name"], "start_ns": sp["t0_ns"], "end_ns": sp["t1_ns"],
        "thread": threading.current_thread().name,
        "trace_id": sp["trace_id"], "span_id": sp["span_id"],
        "parent_span_id": sp.get("parent_span_id", ""),
        "attrs": sp.get("attrs") or {}, "manual": manual})


def local_spans() -> List[Dict[str, Any]]:
    """The finished spans in this process's buffer, oldest first, without
    draining it: dicts of name, start_ns and end_ns
    (``time.perf_counter_ns``), thread, trace_id, span_id,
    parent_span_id, attrs and manual (a span started and ended apart)."""
    return list(_local)


def local_span_stats() -> Dict[str, int]:
    """{"kept", "dropped", "capacity"}: the buffer keeps the newest
    ``capacity`` spans and counts the older ones it let go."""
    return {"kept": len(_local), "dropped": _local_dropped,
            "capacity": LOCAL_CAPACITY}


def clear_local_spans() -> None:
    global _local_dropped
    _local.clear()
    _local_dropped = 0


def _on_gc(phase: str, info: dict) -> None:
    # no imports and no config lookups that could import: this runs inside
    # the collector, on whichever thread triggered it
    global _gc_start
    if phase == "start":
        on = _ENABLED or _flag_seen or _profiling()
        _gc_start = time.perf_counter_ns() if on else None
        return
    if _gc_start is None:
        return
    t0, _gc_start = _gc_start, None
    _keep({"name": "host.gc", "t0_ns": t0, "t1_ns": time.perf_counter_ns(),
           "trace_id": "", "span_id": "",
           "attrs": {"generation": info.get("generation", -1),
                     "collected": info.get("collected", 0)}})


def _hook_gc() -> None:
    global _gc_hooked
    _gc_hooked = True
    gc.callbacks.append(_on_gc)


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def derive_trace_id(task_id: bytes) -> str:
    """Deterministic W3C-shaped trace id for a DERIVE_CTX root task."""
    return (task_id.hex() + "0" * 32)[:32]


def current_span() -> Optional[dict]:
    return _current_span.get()


def inject_context() -> Optional[dict]:
    """Context dict for an outgoing TaskSpec (reference:
    _DictPropagator.inject). A root caller (no active span) stamps the
    constant DERIVE_CTX so the spec stays template-encodable; the executor
    derives the trace id from the task id."""
    if not tracing_enabled():
        return None
    span = _current_span.get()
    if span is None:
        return DERIVE_CTX
    return {"trace_id": span["trace_id"], "parent_span_id": span["span_id"]}


def resolve_context(ctx: Optional[dict], task_id: bytes) -> Optional[dict]:
    """Materialize a wire trace_ctx into {trace_id, parent_span_id},
    deriving ids for the root sentinel form."""
    if ctx is None:
        return None
    tid = ctx.get("trace_id")
    if not tid:
        return {"trace_id": derive_trace_id(task_id), "parent_span_id": ""}
    return {"trace_id": tid, "parent_span_id": ctx.get("parent_span_id", "")}


@contextlib.contextmanager
def execution_span(spec, recorder=None):
    """Open a span around one task execution; records on exit (reference:
    the _function_span/_actor_span wrappers in tracing_helper.py)."""
    ctx = getattr(spec, "trace_ctx", None)
    if ctx is None:
        # the spec's trace_ctx IS the opt-in: a submitter that injected it
        # must get spans even if this worker's env lacks the flag
        yield None
        return
    ctx = resolve_context(ctx, spec.task_id.binary())
    span = {
        "trace_id": ctx["trace_id"],
        "span_id": _new_id(8),
        "parent_span_id": ctx.get("parent_span_id", ""),
        "name": spec.name or spec.method_name or spec.function_key,
        "start": time.time(),
    }
    token = _current_span.set(span)
    try:
        yield span
    finally:
        _current_span.reset(token)
        span["end"] = time.time()
        if recorder is not None:
            try:
                recorder(span)
            except Exception:  # noqa: BLE001 — tracing must never fail a task
                pass


def record_span(span: dict, task_id: bytes = b"") -> None:
    """Record a finished span dict into this process's task-event buffer
    (drained to the control store by the telemetry loop). Never raises."""
    try:
        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
    except Exception:  # noqa: BLE001 — no live core worker in this process
        return
    try:
        cw.task_events.record(
            task_id=task_id,
            name=span["name"], kind=0, event="SPAN",
            worker_id=cw.worker_id.binary(),
            node_id=cw.node_id_hex or "",
            ts=span["start"],
            duration_s=span.get("end", span["start"]) - span["start"],
            extra={"trace_id": span["trace_id"],
                   "span_id": span["span_id"],
                   "parent_span_id": span.get("parent_span_id", "")},
        )
    except Exception:  # noqa: BLE001 — tracing must never fail the caller
        pass


_NULL_SPAN = contextlib.nullcontext()


def _open(name: str, parent: Optional[dict], attrs: Optional[dict]) -> dict:
    cur = parent if parent is not None else _current_span.get()
    return {
        "trace_id": cur["trace_id"] if cur else _new_id(16),
        "span_id": _new_id(8),
        "parent_span_id": (cur.get("span_id") or
                           cur.get("parent_span_id", "")) if cur else "",
        "name": name,
        "start": time.time(),
        "t0_ns": time.perf_counter_ns(),
        "attrs": dict(attrs) if attrs else {},
        # the task-event plane keeps to the flag; the local buffer also
        # takes spans recorded because a profiler runs
        "export": tracing_enabled(),
    }


class _Span:
    __slots__ = ("name", "parent", "task_id", "attrs", "sp", "token", "rf")

    def __init__(self, name, parent, task_id, attrs):
        self.name, self.parent = name, parent
        self.task_id, self.attrs = task_id, attrs

    def __enter__(self) -> dict:
        self.sp = sp = _open(self.name, self.parent, self.attrs)
        self.token = _current_span.set(sp)
        self.rf = rf = _annotate(self.name)
        # the clock is read just before the annotation opens, as on exit
        # just before it closes, so that the two agree
        sp["t0_ns"] = time.perf_counter_ns()
        if rf is not None:
            rf.__enter__()
        return sp

    def __exit__(self, *exc) -> None:
        sp = self.sp
        sp["t1_ns"] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _current_span.reset(self.token)
        sp["end"] = time.time()
        _keep(sp)
        if sp["export"]:
            record_span(sp, task_id=self.task_id)


def span(name: str, parent: Optional[dict] = None, task_id: bytes = b"",
         attrs: Optional[dict] = None, on: Optional[bool] = None):
    """Explicit span in the current process: chains to the current span
    (or an explicit `parent` {trace_id, span_id} captured earlier — batch
    flushes run in timer callbacks outside the request context), installs
    itself as current for the body, and on exit goes to the local buffer
    and, with the flag on, through the task-event plane. `attrs` holds
    integers and short strings; the body may add to the yielded span's
    ``attrs`` (`set_attrs`). Yields None when nothing records; `on` passes
    a `recording()` answer the caller already holds."""
    if not (recording() if on is None else on):
        return _NULL_SPAN
    return _Span(name, parent, task_id, attrs)


def set_attrs(sp: Optional[dict], **attrs) -> None:
    """Add attributes to an open span (no-op for None)."""
    if sp is not None:
        sp["attrs"].update(attrs)


def start_manual_span(name: str, parent: Optional[dict] = None,
                      attrs: Optional[dict] = None,
                      on: Optional[bool] = None) -> Optional[dict]:
    """Span helper for code that cannot hold a context manager open across
    its lifetime (async generators driven by a remote consumer: a `with`
    spanning yields would leak the contextvar into the consumer's turns;
    a request's wait in a queue). Finish with end_manual_span(). Manual
    spans enter no ``record_function``: they may end on another thread."""
    if not (recording() if on is None else on):
        return None
    return _open(name, parent, attrs)


@contextlib.contextmanager
def installed_span(sp: Optional[dict]):
    """Install an already-created manual span as the current context for a
    region (so submissions inside chain to it) WITHOUT finishing it — the
    companion to start_manual_span/end_manual_span for code whose span
    lifetime outlives any single `with` block (SSE write loops, generator
    scheduling turns). No-op for None."""
    if sp is None:
        yield
        return
    token = _current_span.set(sp)
    try:
        yield
    finally:
        _current_span.reset(token)


def end_manual_span(sp: Optional[dict], *, end_ns: Optional[int] = None,
                    **attrs) -> None:
    """Finish a manual span, now or at ``end_ns`` (a
    ``time.perf_counter_ns()`` reading taken earlier). `attrs` join its
    local attributes and, for the task-event plane, its name
    (``name[k=v,...]``)."""
    if sp is None:
        return
    now = time.perf_counter_ns()
    sp["t1_ns"] = now if end_ns is None else end_ns
    sp["end"] = time.time() - (now - sp["t1_ns"]) * 1e-9
    sp["attrs"].update(attrs)
    _keep(sp, manual=True)
    if not sp["export"]:
        return
    if attrs:
        sp["name"] = sp["name"] + "[" + ",".join(
            f"{k}={v}" for k, v in sorted(attrs.items())) + "]"
    record_span(sp)


def bind_span(fn, span: dict):
    """Wrap a SYNC user function so the span is the current context inside
    the executor THREAD it runs on (run_in_executor does not propagate
    contextvars) — nested task submissions from sync tasks then chain."""
    import functools

    @functools.wraps(fn)
    def wrapped(*a, **k):
        token = _current_span.set(span)
        try:
            return fn(*a, **k)
        finally:
            _current_span.reset(token)

    return wrapped


def bind_generator(gen, span: dict):
    """Wrap a SYNC generator so each body step runs with the span current —
    the body executes on arbitrary pool threads during streaming iteration
    (run_in_executor), where the construction-time binding is invisible."""

    def it():
        while True:
            token = _current_span.set(span)
            try:
                item = next(gen)
            except StopIteration:
                return
            finally:
                _current_span.reset(token)
            yield item

    return it()


def list_spans(limit: int = 1000) -> List[Dict[str, Any]]:
    """Finished spans recorded through the task-event plane (driver-side
    view over the cluster's trace history). Reads RAW task events — the
    per-task latest-state collapse of list_tasks() would drop SPAN records
    once the task's FINISHED event lands."""
    from ray_tpu_torch.util.state import _control_call

    reply = _control_call("list_task_events", {"limit": limit * 4})
    out = []
    for ev in reply["events"]:
        if ev.get("event") == "SPAN" and ev.get("trace_id"):
            out.append({
                "task_id": ev["task_id"].hex(),
                "name": ev["name"],
                "event": "SPAN",
                "trace_id": ev["trace_id"],
                "span_id": ev["span_id"],
                "parent_span_id": ev.get("parent_span_id", ""),
                "ts": ev["ts"],
                "duration_s": ev.get("duration_s"),
                "node_id": ev.get("node_id", ""),
            })
    return out[-limit:]


__all__ = ["DERIVE_CTX", "bind_generator", "bind_span", "clear_local_spans",
           "current_span", "derive_trace_id", "enable_tracing",
           "end_manual_span", "execution_span", "inject_context",
           "installed_span", "list_spans", "local_span_stats", "local_spans",
           "record_span", "recording", "resolve_context", "set_attrs", "span",
           "start_manual_span", "tracing_enabled"]
