"""The program's own spans on the traced run's device timeline.

``ray_tpu_torch.util.tracing`` keeps every finished span of the process in
a local buffer, on ``time.perf_counter_ns()``, while tracing is on or a
profiler records. The spans of the thread that runs the profiler also
enter the Chrome trace as ``user_annotation`` events, on the trace's own
clock (on the CPU build of torch that is the wall clock, not
``perf_counter``). So the two are joined, not assumed: each annotation is
paired with the buffered span of its name whose start lies nearest after
the offset that pairs the most of them, and the offset is the median of
the paired start differences. Every buffered span, of any thread, is then
placed on the device timeline. A program without the buffer (or a run
whose buffer holds nothing the trace names) maps nothing, and the readers
of this module return None.

``split`` divides the stretch's device-idle time by what the host was
doing: ``host.gc`` where a collection ran, else the innermost span of the
profiled threads, else the innermost span of the other threads, else
``not covered``. Manual spans (a request's time in a queue) hold no
thread's activity and are left out of it.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

MATCH_US = 1000.0     # an annotation and its buffered span start this close
DUR_SHARE = 0.02      # ... and last within 2% (+ 20 us) of each other
GC = "host.gc"


def buffered() -> List[dict]:
    """The process's buffered spans, or [] where the program keeps none."""
    try:
        from ray_tpu_torch.util import tracing
    except ImportError:
        return []
    read = getattr(tracing, "local_spans", None)
    return read() if read is not None else []


class Span:
    __slots__ = ("ts", "end", "name", "thread", "attrs", "manual")

    def __init__(self, ts, end, name, thread, attrs, manual):
        self.ts, self.end, self.name = ts, end, name
        self.thread, self.attrs, self.manual = thread, attrs, manual

    @property
    def ms(self) -> float:
        return (self.end - self.ts) * 1e-3


class Mapped:
    """The buffer on the trace's clock (microseconds): ``offset_us`` added
    to ``perf_counter_ns / 1000``; ``residual_us`` the largest distance of
    a paired start from that offset; ``pairs`` how many were paired;
    ``profiled`` the threads whose spans the trace holds."""

    def __init__(self, tr, recs: List[dict], offset_us: float,
                 residual_us: float, pairs: int, profiled: set):
        self.tr = tr
        self.offset_us, self.residual_us = offset_us, residual_us
        self.pairs, self.profiled = pairs, profiled
        self.spans = sorted(
            (Span(r["start_ns"] * 1e-3 + offset_us,
                  r["end_ns"] * 1e-3 + offset_us, r["name"], r["thread"],
                  r.get("attrs") or {}, r.get("manual", False))
             for r in recs), key=lambda s: s.ts)

    def within(self, name: str) -> List[Span]:
        """The spans of ``name`` that lie wholly inside the stretch."""
        t0, t1 = self.tr.t0, self.tr.t1
        return [s for s in self.spans
                if s.name == name and s.ts >= t0 and s.end <= t1]

    # -- the idle split ------------------------------------------------

    def _innermost(self, spans: List[Span], label) -> List[Tuple]:
        """Non-overlapping (a, b, label) segments: at each time the span
        that started last among those open."""
        evs = []
        for i, s in enumerate(spans):
            evs.append((s.ts, 1, i))
            evs.append((s.end, 0, i))
        evs.sort()
        open_: Dict[int, Span] = {}
        out, prev = [], None
        for t, kind, i in evs:
            if prev is not None and open_ and t > prev:
                top = max(open_.values(), key=lambda s: s.ts)
                out.append((prev, t, label(top)))
            if kind:
                open_[i] = spans[i]
            else:
                open_.pop(i, None)
            prev = t
        return out

    def split(self) -> Dict[str, float]:
        """{what the host did: seconds} over the stretch's device-idle
        time; the keys include ``idle_s`` (the total) and ``not covered``."""
        tr = self.tr
        idle, prev = [], tr.t0
        for a, b in tr._busy():
            if a > prev:
                idle.append((prev, a))
            prev = max(prev, b)
        if tr.t1 > prev:
            idle.append((prev, tr.t1))

        def name(s):
            what = s.attrs.get("what")
            return f"{s.name}.{what}" if what else s.name

        acts = [s for s in self.spans if not s.manual]
        levels = [
            self._innermost([s for s in acts if s.name == GC], name),
            self._innermost([s for s in acts if s.name != GC
                             and s.thread in self.profiled], name),
            self._innermost([s for s in acts if s.name != GC
                             and s.thread not in self.profiled], name),
        ]
        starts = [[seg[0] for seg in lv] for lv in levels]

        def at(t):
            for lv, st in zip(levels, starts):
                i = bisect.bisect_right(st, t) - 1
                if i >= 0 and lv[i][0] <= t < lv[i][1]:
                    return lv[i][2]
            return "not covered"

        cuts = sorted({t for lv in levels for seg in lv for t in seg[:2]})
        out: Dict[str, float] = defaultdict(float)
        for a, b in idle:
            pts = [a] + cuts[bisect.bisect_right(cuts, a):
                             bisect.bisect_left(cuts, b)] + [b]
            for x, y in zip(pts, pts[1:]):
                if y > x:
                    out[at((x + y) / 2)] += (y - x) * 1e-6
        total = sum((b - a) for a, b in idle) * 1e-6
        return {"idle_s": total, **dict(sorted(out.items(),
                                              key=lambda kv: -kv[1]))}


def _pairs(ann: Dict[str, List[tuple]], buf: Dict[str, List[dict]],
           offset: float) -> List[Tuple[float, dict]]:
    """(start difference, trace minus buffer; buffered span) of each
    annotation paired at ``offset``."""
    out = []
    for name, evs in ann.items():
        recs = buf[name]
        starts = [r["start_ns"] * 1e-3 + offset for r in recs]
        for ts, end, _ in evs:
            i = bisect.bisect_left(starts, ts - MATCH_US)
            best = None
            while i < len(starts) and starts[i] <= ts + MATCH_US:
                if _alike(recs[i], ts, end) and (
                        best is None
                        or abs(starts[i] - ts) < abs(starts[best] - ts)):
                    best = i
                i += 1
            if best is not None:
                out.append((ts - starts[best] + offset, recs[best]))
    return out


def _alike(r: dict, ts: float, end: float) -> bool:
    dur = (r["end_ns"] - r["start_ns"]) * 1e-3
    return abs(dur - (end - ts)) <= DUR_SHARE * (end - ts) + 20.0


def mapped(tr) -> Optional[Mapped]:
    """The buffer mapped onto ``tr`` (a ``devtrace.Trace``), computed once
    a trace; None where nothing pairs."""
    if "_progspans" not in tr.__dict__:
        tr.__dict__["_progspans"] = _map(tr, buffered())
    return tr.__dict__["_progspans"]


def _map(tr, recs: List[dict]) -> Optional[Mapped]:
    buf: Dict[str, List[dict]] = defaultdict(list)
    for r in recs:
        if not r.get("manual"):
            buf[r["name"]].append(r)
    ann: Dict[str, List[tuple]] = defaultdict(list)
    for s in tr.spans:
        if s[2] in buf:
            ann[s[2]].append(s)
    if not ann:
        return None
    for v in buf.values():
        v.sort(key=lambda r: r["start_ns"])
    # candidate offsets: the name with the most annotations, its first
    # annotations against each buffered span of a like duration; the one
    # that pairs the most annotations wins
    name = max(ann, key=lambda n: len(ann[n]))
    cands = {round(ts - r["start_ns"] * 1e-3, 1)
             for ts, end, _ in ann[name][:8] for r in buf[name]
             if _alike(r, ts, end)}
    best, most = None, 0
    for c in cands:
        n = len(_pairs(ann, buf, c))
        if n > most:
            best, most = c, n
    if best is None:
        return None
    offset = statistics.median(d for d, _ in _pairs(ann, buf, best))
    pairs = _pairs(ann, buf, offset)
    if not pairs:
        return None
    return Mapped(tr, recs, offset, max(abs(d - offset) for d, _ in pairs),
                  len(pairs), {r["thread"] for _, r in pairs})


# -- the readers of the metrics that read the program's spans ---------------


def _within(ctx, name: str) -> List[Span]:
    tr = ctx.get("trace")
    m = mapped(tr) if tr is not None else None
    return m.within(name) if m is not None else []


def mean_ms(ctx, name: str, keep=lambda s: True) -> Optional[float]:
    """Mean host time of the stretch's ``name`` spans (those ``keep``
    takes)."""
    spans = [s for s in _within(ctx, name) if keep(s)]
    return sum(s.ms for s in spans) / len(spans) if spans else None


def share(ctx, name: str, part: str, whole: str) -> Optional[float]:
    """100 x sum of attribute ``part`` over sum of ``whole``, over the
    stretch's ``name`` spans."""
    spans = _within(ctx, name)
    den = sum(s.attrs.get(whole, 0) for s in spans)
    return 100.0 * sum(s.attrs.get(part, 0) for s in spans) / den \
        if den else None


def step_gap_ms(ctx) -> Optional[float]:
    """Mean time from one ``engine.step``'s end to the next one's start,
    over the stretch's consecutive steps with no ``engine.admit`` between
    them."""
    steps = _within(ctx, "engine.step")
    admits = sorted(s.ts for s in _within(ctx, "engine.admit"))
    gaps = []
    for a, b in zip(steps, steps[1:]):
        i = bisect.bisect_right(admits, a.end)
        if i < len(admits) and admits[i] < b.ts:
            continue
        gaps.append(b.ts - a.end)
    return sum(gaps) / len(gaps) * 1e-3 if gaps else None


def device_ms(ctx, name: str) -> Optional[float]:
    """Device time of the kernels launched inside ``name`` spans (the
    program's own annotations), per span, over the spans whose kernels the
    stretch holds whole."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    per = [sum(e - s for s, e, _, _ in ks) * 1e-6
           for ks in tr.by_span(name).values()
           if ks and min(k[0] for k in ks) >= tr.t0
           and max(k[1] for k in ks) <= tr.t1]
    return 1e3 * sum(per) / len(per) if per else None
