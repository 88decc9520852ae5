"""The traced run's profile: ``torch.profiler`` over a steady stretch of the
window, written as a Chrome trace into the run's TMPDIR and read back.

The stretch is the host span ``portbench.window``. Kernels (and device
copies and fills) are attributed to the harness's spans by their launch:
a kernel belongs to a span when the runtime call that launched it lies
inside the span's host interval. The harness's spans are named
``portbench.<what>[.<shape>]``.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profile:
    """Starts ``torch.profiler``; ``open`` opens the window span, which
    the caller does once the device is busy again (starting the profiler
    holds the host while the device drains); ``stop`` closes both (after a
    device synchronize) and writes the trace to ``path``. All three calls
    come from the thread that runs the traced work."""

    def __init__(self, path: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.path = path
        self._prof = profile(activities=acts, record_shapes=False,
                             with_stack=False, profile_memory=False)
        self._prof.start()
        self._span = None

    def open(self):
        import torch

        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if self._span is not None:
            self._span.__exit__(None, None, None)
        self._prof.stop()
        if self.path:
            self._prof.export_chrome_trace(self.path)


def warm():
    """Start and stop the profiler once, in set-up and on the thread that
    will trace, so that its first start (CUPTI and Kineto coming up) falls
    outside the window."""
    Profile(None).stop()


class Trace:
    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels, launch, spans, ops = [], {}, [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts = float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                kernels.append((ts, end, e.get("name", ""),
                                args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if args.get("correlation") is not None:
                    launch[args["correlation"]] = ts
            elif cat == "user_annotation":
                spans.append((ts, end, e.get("name", "")))
            elif cat == "cpu_op":
                ops.append((ts, end, e.get("name", "")))
        win = [s for s in spans if s[2] == WINDOW]
        if not win:
            raise ValueError(f"no {WINDOW} span in {path}")
        self.t0, self.t1 = win[0][0], win[0][1]
        self.kernels = sorted(k for k in kernels
                              if k[1] > self.t0 and k[0] < self.t1)
        self.launch = launch
        self.spans = sorted(s for s in spans if s[2] != WINDOW)
        self.ops = ops

    # -- the window ------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for ts, end, _, _ in self.kernels:
            ts, end = max(ts, self.t0), min(end, self.t1)
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def idle_percent(self) -> Optional[float]:
        """The share of the stretch with nothing running on the device
        (kernels, copies and fills)."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    # -- attribution -----------------------------------------------------

    def by_span(self, prefix: str) -> Dict[Tuple[float, float, str], list]:
        """{span: [kernel, ...]} for the spans whose name starts with
        ``prefix``, each kernel (ts, end, name, correlation) launched inside
        the span. Spans of one prefix do not overlap."""
        spans = [s for s in self.spans if s[2].startswith(prefix)]
        starts = [s[0] for s in spans]
        out = {s: [] for s in spans}
        for k in self.kernels:
            t = self.launch.get(k[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out[spans[i]].append(k)
        return out

    def extents(self, prefix: str) -> List[Tuple[str, float]]:
        """[(span name, seconds)] for each span of ``prefix`` whose kernels
        all ran inside the window: first kernel start to last kernel end."""
        out = []
        for span, ks in self.by_span(prefix).items():
            if ks:
                a, b = min(k[0] for k in ks), max(k[1] for k in ks)
                if a >= self.t0 and b <= self.t1:
                    out.append((span[2], (b - a) * 1e-6))
        return out

    def named(self, part: str) -> list:
        """Kernels in the window whose name holds ``part``."""
        return [k for k in self.kernels if part in k[2]]

    # -- breakdown -------------------------------------------------------

    def device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for ts, end, name, _ in self.kernels:
            tot[name[:120]] += (min(end, self.t1) - max(ts, self.t0)) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        """The innermost harness span and host op around host time t."""
        def inner(evs):
            best: Optional[tuple] = None
            for ts, end, name in evs:
                if ts <= t <= end and (best is None or end - ts < best[1] - best[0]):
                    best = (ts, end, name)
            return best[2] if best else None

        span, op = inner(self.spans), inner(self.ops)
        return "/".join(x for x in (span, op) if x) or "host"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches with nothing on the device, each named by
        what the host was doing when it launched the work that ended it."""
        busy = self._busy()
        gaps = []
        prev = self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((a - prev, prev, a))
            prev = b
        if self.t1 > prev:
            gaps.append((self.t1 - prev, prev, self.t1))
        gaps.sort(reverse=True)
        starts = [k[0] for k in self.kernels]
        out = []
        for dur, a, b in gaps[:n]:
            i = bisect.bisect_left(starts, b)
            t = self.launch.get(self.kernels[i][3]) if i < len(self.kernels) \
                else None
            out.append([self._host_at(t) if t is not None else "window end",
                        dur * 1e-6])
        return out
