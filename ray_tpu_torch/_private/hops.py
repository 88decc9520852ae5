"""Per-hop latency decomposition of the task path.

The sync task path crosses a fixed sequence of hops:

    submit_encode   .remote() entry → spec encoded + enqueued
                    (caller thread: serialize, spec build, ring push)
    ring_wait       enqueued → a push feeder pops it
                    (native ring wait stamped in fastpath.cc, Python queue
                    wait stamped on the spec)
    frame_build     batch popped → the push_task_batch frame is built/encoded
    wire_rtt        frame written → reply received, MINUS the worker's
                    server-side time (transport + event-loop scheduling)
    grant           a FRESH lease request → grant (daemon-side wait carried
                    in the lease reply; pooled leases skip this hop)
    exec_dequeue    worker received the batch → this task's user fn starts
                    (executor-thread hop + queue position)
    user_fn         the user function body
    completion      reply received by the owner → returns recorded/resolved

Every hop folds into the `rt_task_hop_seconds{hop=...}` histogram —
observed in BATCHES (one lock per push batch, not per task) so the fold
itself stays off the critical path. Owner-side hops land in the driver's
registry, worker-side hops in each worker's; the delta-telemetry plane
merges them at the control store, so the cluster-wide histogram decomposes
where a call actually spends its time. `breakdown()` reads the merged
series back for bench_core's per-hop report.

Enabled with tracing (`tracing_enabled` flag): hop stamps are ~100ns of
time.monotonic_ns() per hop and the A/B in bench_core/BENCH_OBS proves the
whole plane costs < 5% of 100k-queue submit rate.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

HOPS = ("submit_encode", "ring_wait", "frame_build", "wire_rtt", "grant",
        "exec_dequeue", "user_fn", "completion")

# µs-scale buckets up to 1s: sync calls are microsecond-bound, stragglers
# (cold worker spawn, spill) land in the tail buckets
BOUNDARIES = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0,
)

_hist = None
_hist_gen = None


def enabled() -> bool:
    from ray_tpu_torch.util.tracing import tracing_enabled

    return tracing_enabled()


def now_ns() -> int:
    return time.monotonic_ns()


def histogram():
    """The per-process hop histogram (re-resolved after a registry reset;
    construction is registration-atomic, so concurrent first calls from
    the loop and executor threads converge on one instance)."""
    global _hist, _hist_gen
    from ray_tpu_torch.util import metrics

    gen = metrics.registry_generation()
    if _hist is None or _hist_gen != gen:
        _hist = metrics.Histogram(
            "rt_task_hop_seconds",
            "Per-hop latency decomposition of the task path "
            "(submit encode, ring wait, frame build, wire RTT, lease "
            "grant, worker dequeue, user fn, completion delivery)",
            boundaries=BOUNDARIES, tag_keys=("hop",))
        _hist_gen = gen
    return _hist


def observe_ns(hop: str, ns: int) -> None:
    if ns < 0:
        ns = 0
    try:
        histogram().observe(ns / 1e9, {"hop": hop})
    except Exception:  # noqa: BLE001 — telemetry must never fail the path
        pass


def observe_many_ns(hop: str, ns_values: Iterable[int]) -> None:
    """Batched fold: one histogram lock per push batch."""
    vals = [max(0, v) / 1e9 for v in ns_values]
    if not vals:
        return
    try:
        histogram().observe_many(vals, {"hop": hop})
    except Exception:  # noqa: BLE001
        pass


def breakdown(series: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Per-hop {count, mean_us, p50_us, p99_us} from rt_task_hop_seconds
    series (cluster-aggregated when passed the control store's merged
    metrics; this process's snapshot otherwise). Percentiles interpolate
    within the matched bucket — honest enough to name the dominant hop."""
    if series is None:
        from ray_tpu_torch.util import metrics

        series = [s for s in metrics.snapshot_all()
                  if s["name"] == "rt_task_hop_seconds"]
    merged: Dict[str, dict] = {}
    for s in series:
        if s.get("type") != "histogram":
            continue
        hop = s.get("tags", {}).get("hop", "")
        cur = merged.get(hop)
        if cur is None:
            merged[hop] = {"counts": list(s["counts"]), "sum": s["sum"],
                           "boundaries": list(s["boundaries"])}
        else:
            cur["counts"] = [a + b for a, b in zip(cur["counts"],
                                                   s["counts"])]
            cur["sum"] += s["sum"]

    def pct(bounds, counts, q):
        total = sum(counts)
        if not total:
            return 0.0
        target = total * q
        cum = 0
        lo = 0.0
        for i, c in enumerate(counts):
            hi = bounds[i] if i < len(bounds) else bounds[-1] * 2
            if cum + c >= target:
                frac = (target - cum) / c if c else 0.0
                return lo + (hi - lo) * frac
            cum += c
            lo = hi
        return lo

    out: Dict[str, dict] = {}
    for hop, agg in merged.items():
        n = sum(agg["counts"])
        out[hop] = {
            "count": n,
            "mean_us": round(agg["sum"] / n * 1e6, 2) if n else 0.0,
            "p50_us": round(pct(agg["boundaries"], agg["counts"], 0.5) * 1e6,
                            2),
            "p99_us": round(pct(agg["boundaries"], agg["counts"], 0.99) * 1e6,
                            2),
            "total_s": round(agg["sum"], 6),
        }
    return out


def dominant_hop(bd: Dict[str, dict]) -> str:
    """The hop where the path spends the most total time (wire_rtt already
    excludes server time; user_fn is excluded — it is the payload, not
    framework overhead)."""
    cands = {h: v["total_s"] for h, v in bd.items()
             if h != "user_fn" and v["count"]}
    return max(cands, key=cands.get) if cands else ""


__all__ = ["BOUNDARIES", "HOPS", "breakdown", "dominant_hop", "enabled",
           "histogram", "now_ns", "observe_many_ns", "observe_ns"]
