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
kept as an override and `enable_tracing()` sets it for child processes.

W3C-style ids (32-hex trace ids, 16-hex span ids) keep the contexts
interoperable with OTel propagators.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
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
            return os.environ.get("RT_TRACING_ENABLED", "") in ("1", "true")
    try:
        if _CONFIG.get("tracing_enabled"):
            return True
    except Exception:  # noqa: BLE001 — registry mid-reset
        pass
    return os.environ.get("RT_TRACING_ENABLED", "") in ("1", "true")


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


@contextlib.contextmanager
def span(name: str, parent: Optional[dict] = None, task_id: bytes = b""):
    """Explicit span in the current process: chains to the current span
    (or an explicit `parent` {trace_id, span_id} captured earlier — batch
    flushes run in timer callbacks outside the request context), installs
    itself as current for the body, and records through the task-event
    plane on exit. Yields None (and costs one contextvar read) when
    tracing is off."""
    if not tracing_enabled():
        yield None
        return
    cur = parent if parent is not None else _current_span.get()
    sp = {
        "trace_id": cur["trace_id"] if cur else _new_id(16),
        "span_id": _new_id(8),
        "parent_span_id": (cur.get("span_id") or
                           cur.get("parent_span_id", "")) if cur else "",
        "name": name,
        "start": time.time(),
    }
    token = _current_span.set(sp)
    try:
        yield sp
    finally:
        _current_span.reset(token)
        sp["end"] = time.time()
        record_span(sp, task_id=task_id)


def start_manual_span(name: str, parent: Optional[dict] = None
                      ) -> Optional[dict]:
    """Span helper for code that cannot hold a context manager open across
    its lifetime (async generators driven by a remote consumer: a `with`
    spanning yields would leak the contextvar into the consumer's turns).
    Finish with end_manual_span()."""
    if not tracing_enabled():
        return None
    cur = parent if parent is not None else _current_span.get()
    return {
        "trace_id": cur["trace_id"] if cur else _new_id(16),
        "span_id": _new_id(8),
        "parent_span_id": (cur.get("span_id") or
                           cur.get("parent_span_id", "")) if cur else "",
        "name": name,
        "start": time.time(),
    }


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


def end_manual_span(sp: Optional[dict], **attrs) -> None:
    if sp is None:
        return
    sp["end"] = time.time()
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


__all__ = ["DERIVE_CTX", "bind_generator", "bind_span", "current_span",
           "derive_trace_id", "enable_tracing", "end_manual_span",
           "execution_span", "inject_context", "installed_span",
           "list_spans", "record_span", "resolve_context", "span",
           "start_manual_span", "tracing_enabled"]
