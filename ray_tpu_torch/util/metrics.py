"""User-defined metrics: Counter / Gauge / Histogram.

Reference surface: python/ray/util/metrics.py (Counter :147, Gauge :204,
Histogram :263 — tag_keys, default_tags, inc/set/observe) backed by the C++
registry (src/ray/stats/metric.h:104). Here every process keeps a local
registry; the core worker's telemetry loop ships DELTAS (counters and
histogram buckets as increments since the last flush, gauges as current
values) through the node daemon's per-node pre-aggregation to the control
store, which accumulates them; `prometheus_text()` renders the cluster-wide
aggregate in Prometheus exposition format (the reference exports through the
per-node agent to Prometheus).

Registration is idempotent: constructing a metric whose name is already
registered returns the EXISTING instance when the type and tag_keys (and
histogram boundaries) match, and raises on a mismatch — same-name
re-registration used to silently clobber the registered instance, dropping
every value the old one had accumulated between flushes.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[str, "Metric"] = {}
# reentrant: get_or_create_* constructs (which registers) while holding the
# lock, so lookup-or-create is one atomic step
_REG_LOCK = threading.RLock()
# bumped by reset_registry() so modules caching metric handles (hops,
# task-event drop counters) can detect that their handle went stale
_GENERATION = 0


def _tags_key(tags: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(tags.items()))


def registry_generation() -> int:
    return _GENERATION


def reset_registry() -> None:
    """Drop every registered metric (test isolation: a suite re-declaring a
    name with a different shape must not trip the mismatch check on another
    test's leftovers). Cached handles elsewhere detect the reset through
    registry_generation()."""
    global _GENERATION
    with _REG_LOCK:
        _REGISTRY.clear()
        _GENERATION += 1


class Metric:
    metric_type = "untyped"

    def __new__(cls, name: str = "", *args, **kwargs):
        if name:
            with _REG_LOCK:
                existing = _REGISTRY.get(name)
                if existing is not None:
                    if type(existing) is not cls:
                        raise TypeError(
                            f"metric {name!r} already registered as "
                            f"{existing.metric_type}, not {cls.metric_type}")
                    # __init__ re-runs on the returned instance: each class
                    # guards with `self._registered` and only VALIDATES
                    return existing
        return super().__new__(cls)

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name required")
        if getattr(self, "_registered", False):
            # __new__ handed back the registered instance: only validate
            if tuple(tag_keys or ()) != self.tag_keys:
                raise ValueError(
                    f"metric {name!r} re-registered with tag_keys="
                    f"{tuple(tag_keys or ())}, conflicting with the "
                    f"registered declaration {self.tag_keys}")
            if description and not self.description:
                self.description = description
            return
        with _REG_LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None:
                # lost a construction race in the window between __new__'s
                # registry check and here: ADOPT the winner's state (shared
                # __dict__) so no thread's increments land on an orphan
                if type(existing) is not type(self):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{existing.metric_type}, not {self.metric_type}")
                if tuple(tag_keys or ()) != existing.tag_keys:
                    raise ValueError(
                        f"metric {name!r} re-registered with tag_keys="
                        f"{tuple(tag_keys or ())}, conflicting with the "
                        f"registered declaration {existing.tag_keys}")
                self.__dict__ = existing.__dict__
                return
            self.name = name
            self.description = description
            self.tag_keys = tuple(tag_keys or ())
            self._default_tags: Dict[str, str] = {}
            self._lock = threading.Lock()
            _REGISTRY[name] = self
            self._registered = True

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        out = dict(self._default_tags)
        if tags:
            out.update(tags)
        extra = set(out) - set(self.tag_keys)
        if extra:
            raise ValueError(f"tags {extra} not declared in tag_keys")
        return out

    def _snapshot(self) -> List[dict]:  # pragma: no cover - abstract
        raise NotImplementedError

    def _take_delta(self) -> List[dict]:
        """Series to ship this telemetry interval. Default: the full
        snapshot (gauges and untyped series are point-in-time values)."""
        return self._snapshot()

    def _untake(self, series: dict) -> None:
        """Undo one _take_delta series after a failed ship so the next
        flush re-includes it. No-op for point-in-time metrics."""


class Counter(Metric):
    """Monotonic counter (reference: util/metrics.py:147)."""

    metric_type = "counter"

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        # state creation AFTER super() (covers both plain re-registration
        # and the adopted-state construction-race path), under _REG_LOCK so
        # two racing first-constructors cannot both install fresh dicts and
        # drop increments landing between the assignments
        with _REG_LOCK:
            if getattr(self, "_values", None) is None:
                self._values: Dict[tuple, float] = {}
                self._shipped: Dict[tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        key = _tags_key(self._merged(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def _snapshot(self):
        with self._lock:
            return [
                {"name": self.name, "type": "counter", "tags": dict(k),
                 "value": v, "help": self.description}
                for k, v in self._values.items()
            ]

    def _take_delta(self):
        out = []
        with self._lock:
            for k, v in self._values.items():
                new = k not in self._shipped
                d = v - self._shipped.get(k, 0.0)
                if d > 0 or new:
                    # a NEVER-shipped series goes out even at zero: eagerly
                    # registered drop counters must exist on the scrape
                    # before the first increment
                    self._shipped[k] = v
                    out.append({"name": self.name, "type": "counter",
                                "tags": dict(k), "value": d,
                                "help": self.description})
        return out

    def _untake(self, series: dict):
        key = _tags_key(series["tags"])
        with self._lock:
            self._shipped[key] = max(
                0.0, self._shipped.get(key, 0.0) - series["value"])


def get_or_create_counter(name: str, description: str = "",
                          tag_keys: Optional[Sequence[str]] = None
                          ) -> Counter:
    """Idempotent Counter handle (kept for compatibility — the constructor
    itself is idempotent now). Atomic under _REG_LOCK."""
    with _REG_LOCK:
        return Counter(name, description, tag_keys)


class Gauge(Metric):
    """Point-in-time value (reference: util/metrics.py:204)."""

    metric_type = "gauge"

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        with _REG_LOCK:
            if getattr(self, "_values", None) is None:
                self._values: Dict[tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _tags_key(self._merged(tags))
        with self._lock:
            self._values[key] = float(value)

    def _snapshot(self):
        with self._lock:
            return [
                {"name": self.name, "type": "gauge", "tags": dict(k),
                 "value": v, "help": self.description}
                for k, v in self._values.items()
            ]


class Histogram(Metric):
    """Bucketed distribution (reference: util/metrics.py:263)."""

    metric_type = "histogram"

    def __init__(self, name, description="", boundaries: Sequence[float] = (),
                 tag_keys=None):
        boundaries = list(boundaries)
        fresh = not getattr(self, "_registered", False)
        if fresh and (not boundaries or boundaries != sorted(boundaries)):
            # validated BEFORE registration so an invalid declaration never
            # lands in the registry (re-registration validates equality
            # against the registered boundaries below instead)
            raise ValueError("boundaries must be a sorted non-empty sequence")
        super().__init__(name, description, tag_keys)
        with _REG_LOCK:
            if getattr(self, "boundaries", None) is not None:
                existing_boundaries = self.boundaries
            else:
                existing_boundaries = None
                self.boundaries = boundaries
                self._counts: Dict[tuple, List[int]] = {}
                self._sums: Dict[tuple, float] = {}
                self._shipped_counts: Dict[tuple, List[int]] = {}
                self._shipped_sums: Dict[tuple, float] = {}
        if existing_boundaries is not None and boundaries \
                and boundaries != existing_boundaries:
            raise ValueError(
                f"metric {name!r} re-registered with different boundaries")

    def _bucket(self, value: float) -> int:
        i = 0
        b = self.boundaries
        while i < len(b) and value > b[i]:
            i += 1
        return i

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _tags_key(self._merged(tags))
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[self._bucket(value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def observe_many(self, values: Sequence[float],
                     tags: Optional[Dict[str, str]] = None):
        """Batched observe: one lock acquisition for a whole batch — the
        per-hop fold on the task hot path records per push batch, not per
        task."""
        if not values:
            return
        key = _tags_key(self._merged(tags))
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            total = 0.0
            for v in values:
                counts[self._bucket(v)] += 1
                total += v
            self._sums[key] = self._sums.get(key, 0.0) + total

    def _snapshot(self):
        with self._lock:
            out = []
            for k, counts in self._counts.items():
                out.append({
                    "name": self.name, "type": "histogram", "tags": dict(k),
                    "boundaries": self.boundaries, "counts": list(counts),
                    "sum": self._sums.get(k, 0.0), "help": self.description,
                })
            return out

    def _take_delta(self):
        out = []
        with self._lock:
            for k, counts in self._counts.items():
                shipped = self._shipped_counts.get(k)
                if shipped is None:
                    shipped = [0] * len(counts)
                d = [a - b for a, b in zip(counts, shipped)]
                if not any(d):
                    continue
                ds = self._sums.get(k, 0.0) - self._shipped_sums.get(k, 0.0)
                self._shipped_counts[k] = list(counts)
                self._shipped_sums[k] = self._sums.get(k, 0.0)
                out.append({
                    "name": self.name, "type": "histogram", "tags": dict(k),
                    "boundaries": self.boundaries, "counts": d,
                    "sum": ds, "help": self.description,
                })
        return out

    def _untake(self, series: dict):
        key = _tags_key(series["tags"])
        with self._lock:
            shipped = self._shipped_counts.get(key)
            if shipped is None:
                return
            self._shipped_counts[key] = [
                max(0, a - b) for a, b in zip(shipped, series["counts"])]
            self._shipped_sums[key] = (
                self._shipped_sums.get(key, 0.0) - series["sum"])


def snapshot_all() -> List[dict]:
    """Every metric series in this process, full values."""
    with _REG_LOCK:
        metrics = list(_REGISTRY.values())
    out: List[dict] = []
    for m in metrics:
        out.extend(m._snapshot())
    return out


def take_delta() -> List[dict]:
    """Series to ship this telemetry interval: counters/histograms as
    increments since the last take, gauges/untyped as current values.
    Deltas make cross-process aggregation exact (the receiver sums them)
    and make a restarted worker's fresh-from-zero counters merge without
    double counting. A taken batch must reach the receiver exactly once:
    the telemetry loops FREEZE it with a sequence number and retry it
    verbatim until acked (receivers dedup by seq); `untake()` is the
    alternative for callers that abandon a batch instead."""
    with _REG_LOCK:
        metrics = list(_REGISTRY.values())
    out: List[dict] = []
    for m in metrics:
        out.extend(m._take_delta())
    return out


def untake(series: List[dict]) -> None:
    """Return un-shipped deltas to their metrics after a failed flush."""
    with _REG_LOCK:
        for s in series:
            m = _REGISTRY.get(s.get("name", ""))
            if m is not None and m.metric_type == s.get("type"):
                try:
                    m._untake(s)
                except Exception:  # noqa: BLE001 — best-effort restore
                    pass


def merge_series(acc: Dict[tuple, dict], series: List[dict],
                 delta: bool) -> None:
    """Fold a reported series list into an accumulator keyed by
    (name, tags, type). Delta payloads ADD counters and histogram buckets;
    full snapshots replace. Gauges always replace (last writer wins).
    Malformed entries are skipped — one bad reporter must not poison the
    node/cluster aggregate."""
    for s in series:
        try:
            key = (s["name"], _tags_key(s["tags"]), s["type"])
            cur = acc.get(key)
            if cur is None:
                acc[key] = {k: (list(v) if isinstance(v, list) else v)
                            for k, v in s.items()}
            elif s["type"] == "counter" and delta:
                cur["value"] = cur["value"] + s["value"]
            elif s["type"] == "histogram" and delta:
                # compute BOTH merged fields before mutating: a malformed
                # entry (counts without sum, None values, wrong bucket
                # count) must be skipped whole, never half-applied into the
                # long-lived accumulator
                if len(s["counts"]) != len(cur["counts"]):
                    continue
                merged_counts = [
                    a + b for a, b in zip(cur["counts"], s["counts"])]
                merged_sum = cur["sum"] + s["sum"]
                cur["counts"] = merged_counts
                cur["sum"] = merged_sum
            else:
                acc[key] = {k: (list(v) if isinstance(v, list) else v)
                            for k, v in s.items()}
        except (KeyError, TypeError):
            continue


def _fmt_tags(tags: Dict[str, str]) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
    return "{" + inner + "}"


def render_prometheus(workers_reply: Dict) -> str:
    """Aggregate per-reporter snapshots (the control store's get_metrics
    reply) into Prometheus exposition text: counters/histograms summed,
    gauges last-writer-wins. Shared by prometheus_text() and the dashboard's
    /metrics endpoint so the two cannot diverge. A malformed series from one
    reporter (missing keys, wrong value shapes) is SKIPPED, not a 500: the
    scrape must keep rendering everyone else's metrics."""
    merged: Dict[tuple, dict] = {}
    for w in workers_reply.values():
        try:
            series = w["metrics"]
        except (KeyError, TypeError):
            continue
        if not isinstance(series, list):
            continue
        for s in series:
            try:
                key = (s["name"], _tags_key(s["tags"]), s["type"])
                cur = merged.get(key)
                if cur is None:
                    merged[key] = dict(s)
                elif s["type"] in ("counter",):
                    merged[key]["value"] += s["value"]
                elif s["type"] == "gauge":
                    merged[key]["value"] = s["value"]
                elif s["type"] == "histogram":
                    merged[key]["counts"] = [
                        a + b
                        for a, b in zip(merged[key]["counts"], s["counts"])
                    ]
                    merged[key]["sum"] += s["sum"]
            except (KeyError, TypeError, AttributeError):
                continue
    lines = []
    seen_help = set()
    for (name, _tk, mtype), s in sorted(merged.items()):
        if name not in seen_help:
            seen_help.add(name)
            lines.append(f"# HELP {name} {s.get('help', '')}")
            lines.append(f"# TYPE {name} {mtype}")
        try:
            if mtype == "histogram":
                cum = 0
                hist_lines = []
                for bound, c in zip(
                        list(s["boundaries"]) + [float("inf")], s["counts"]):
                    cum += c
                    le = "+Inf" if bound == float("inf") else repr(bound)
                    tags = dict(s["tags"], le=le)
                    hist_lines.append(f"{name}_bucket{_fmt_tags(tags)} {cum}")
                hist_lines.append(f"{name}_sum{_fmt_tags(s['tags'])} {s['sum']}")
                hist_lines.append(f"{name}_count{_fmt_tags(s['tags'])} {cum}")
                lines.extend(hist_lines)
            else:
                lines.append(f"{name}{_fmt_tags(s['tags'])} {s['value']}")
        except (KeyError, TypeError):
            continue
    return "\n".join(lines) + "\n"


def prometheus_text() -> str:
    """Cluster-wide metrics in Prometheus exposition format."""
    from ray_tpu_torch._private.core_worker import get_core_worker

    cw = get_core_worker()
    reply = cw.run_sync(cw.control.call("get_metrics", {}))
    return render_prometheus(reply["workers"])
