"""Streaming executor v2: per-stage dispatch, byte-budget backpressure,
actor-pool autoscaling, and per-op stats.

Reference surface: python/ray/data/_internal/execution/streaming_executor.py
:106,423,499 (dedicated scheduling loop), resource_manager.py (in-flight
byte budgets per operator), operators/actor_pool_map_operator.py (min/max
actor autoscaling), python/ray/data/stats.py (per-op timing surfaced by
ds.stats()).

Redesign: the driver runs one pull-based scheduling loop per consumption.
Each stage owns an input queue of block refs and a set of in-flight tasks;
a completed task's output ref moves to the next stage's queue. Admission is
gated by (a) a per-stage in-flight BYTE budget — block sizes are measured
from the node's shm store, falling back to a running average for inline
objects — and (b) the consumer's pull (the bounded, in-order output
buffer). Stateful stages run through an auto-scaling actor pool: the pool
grows while its input queue is deeper than its actors can cover and shrinks
back to min when the queue drains.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from ray_tpu_torch.data.block import Block, normalize_batch

_SMALL_OBJECT_EST = 64 * 1024  # inline objects: assume 64KB until measured
_exec_counter = __import__("itertools").count(1)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------


@dataclass
class OpStats:
    """One pipeline stage's execution metrics (reference: data/stats.py)."""

    name: str
    blocks: int = 0
    bytes_out: int = 0
    task_s_total: float = 0.0       # submit→complete, summed over blocks
    task_s_max: float = 0.0
    peak_in_flight: int = 0
    peak_queued: int = 0
    actors_peak: int = 0            # actor stages only
    backpressure_s: float = 0.0     # time admission was byte-blocked

    def row(self) -> str:
        avg = self.task_s_total / self.blocks if self.blocks else 0.0
        return (f"{self.name[:34]:34} {self.blocks:>6} "
                f"{self.bytes_out / 1e6:>9.1f} {avg * 1e3:>9.1f} "
                f"{self.task_s_max * 1e3:>9.1f} {self.peak_in_flight:>5} "
                f"{self.peak_queued:>5} {self.backpressure_s:>7.2f}")


@dataclass
class DatasetStats:
    """Per-op table + totals; str() renders the table the way the
    reference's ds.stats() does."""

    ops: List[OpStats] = field(default_factory=list)
    wall_s: float = 0.0
    output_blocks: int = 0
    output_bytes: int = 0

    def __str__(self) -> str:
        hdr = (f"{'op':34} {'blocks':>6} {'MB out':>9} {'avg ms':>9} "
               f"{'max ms':>9} {'infl':>5} {'queue':>5} {'bp s':>7}")
        lines = [hdr, "-" * len(hdr)]
        lines += [o.row() for o in self.ops]
        lines.append(
            f"total: {self.output_blocks} blocks, "
            f"{self.output_bytes / 1e6:.1f} MB out, "
            f"wall {self.wall_s:.2f}s")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 4),
            "output_blocks": self.output_blocks,
            "output_bytes": self.output_bytes,
            "ops": [vars(o) for o in self.ops],
        }


_STATS_REGISTRY: "collections.OrderedDict[str, DatasetStats]" = (
    collections.OrderedDict())

def _rt_metrics_emit(stats: DatasetStats) -> None:
    """Thread per-execution totals onto the rt_* metrics plane (the
    cluster-wide Prometheus surface — reference: data's StatsManager
    pushing operator metrics through the metrics agent)."""
    try:
        from ray_tpu_torch.util.metrics import get_or_create_counter

        get_or_create_counter(
            "rt_data_executions_total", "Dataset plan executions").inc(1)
        if stats.output_blocks:
            get_or_create_counter(
                "rt_data_output_blocks_total",
                "Dataset output blocks").inc(stats.output_blocks)
        if stats.output_bytes:
            get_or_create_counter(
                "rt_data_output_bytes_total",
                "Dataset output bytes").inc(stats.output_bytes)
        for op in stats.ops:
            if op.blocks:
                get_or_create_counter(
                    "rt_data_op_blocks_total",
                    "Blocks processed per logical op",
                    tag_keys=("op",)).inc(op.blocks,
                                          tags={"op": op.name[:60]})
    except Exception:  # noqa: BLE001 — metrics must never fail the pipeline
        pass


def record_stats(dataset_tag: str, stats: DatasetStats, *,
                 emit_metrics: bool = True) -> None:
    _STATS_REGISTRY[dataset_tag] = stats
    if emit_metrics:
        # metadata-shortcut queries pass False: they count under
        # rt_data_meta_shortcuts_total, not as plan executions
        _rt_metrics_emit(stats)
    while len(_STATS_REGISTRY) > 64:
        _STATS_REGISTRY.popitem(last=False)
    # surface through the control store so the state API can list dataset
    # executions cluster-wide (reference: data dashboard / StatsManager)
    try:
        import json

        from ray_tpu_torch._private.core_worker import get_core_worker

        cw = get_core_worker()
        cw.run_sync(cw.control.call("kv_put", {
            "ns": "data_stats", "key": dataset_tag.encode(),
            "value": json.dumps(stats.to_dict()).encode(),
            "overwrite": True,
        }))
    except Exception:  # noqa: BLE001 — stats must never fail the pipeline
        pass


def list_recorded_stats() -> Dict[str, DatasetStats]:
    return dict(_STATS_REGISTRY)


# ---------------------------------------------------------------------------
# sizing
# ---------------------------------------------------------------------------


def _ref_size(ref) -> Optional[int]:
    """Size of a block ref if it lives in the local shm store (zero-copy
    metadata peek), else None (inline/memory-store object)."""
    try:
        from ray_tpu_torch._private.core_worker import get_core_worker

        store = get_core_worker().store
        if store is None:
            return None
        got = store.get(ref._id)
        if got is None:
            return None
        view, _ = got
        size = len(view)
        view.release()
        store.release(ref._id)
        return size
    except Exception:  # noqa: BLE001 — sizing is best-effort
        return None


# ---------------------------------------------------------------------------
# auto-scaling actor pool
# ---------------------------------------------------------------------------


_MAP_WORKER_CLS = None


def _map_worker_cls():
    """The one remote map-worker wrapper, shared by every pool (streaming
    and materialize paths must behave identically)."""
    global _MAP_WORKER_CLS
    if _MAP_WORKER_CLS is None:
        import ray_tpu_torch

        @ray_tpu_torch.remote
        class _MapWorker:
            def __init__(self, cls, args, kwargs):
                self._fn = cls(*args, **kwargs)

            def transform(self, block):
                return self._fn(normalize_batch(block))

        _MAP_WORKER_CLS = _MapWorker
    return _MAP_WORKER_CLS


class AutoScalingActorPool:
    """Least-loaded actor pool with queue-driven scaling (reference:
    actor_pool_map_operator.py + actor_autoscaler)."""

    def __init__(self, udf_cls, fn_args, fn_kwargs, min_size: int,
                 max_size: int):
        self._worker_cls = _map_worker_cls()
        self._ctor = (udf_cls, list(fn_args), dict(fn_kwargs))
        self.min_size = max(1, min_size)
        self.max_size = max(self.min_size, max_size)
        self._actors: List[Any] = []
        self._load: Dict[int, int] = {}  # actor index -> outstanding
        self._by_ref: Dict[bytes, int] = {}  # result ref -> actor index
        for _ in range(self.min_size):
            self._add_actor()
        self._idle_polls = 0

    def _add_actor(self):
        self._actors.append(self._worker_cls.remote(*self._ctor))
        self._load[len(self._actors) - 1] = 0

    def submit(self, block_ref):
        i = min(self._load, key=self._load.get)
        self._load[i] += 1
        ref = self._actors[i].transform.remote(block_ref)
        self._by_ref[ref._id.binary()] = i
        return ref

    def task_done(self, ref):
        i = self._by_ref.pop(ref._id.binary(), None)
        if i is not None and i in self._load:
            self._load[i] = max(0, self._load[i] - 1)

    def autoscale(self, queued: int) -> None:
        """Grow while the queue is deeper than the pool can cover; shrink
        back toward min after sustained idleness."""
        size = len(self._actors)
        if queued > size and size < self.max_size:
            self._add_actor()
            self._idle_polls = 0
            return
        if queued == 0 and all(v == 0 for v in self._load.values()):
            self._idle_polls += 1
            if self._idle_polls >= 20 and size > self.min_size:
                import ray_tpu_torch

                idx = size - 1
                try:
                    ray_tpu_torch.kill(self._actors[idx])
                except Exception:  # noqa: BLE001 — already dead
                    pass
                self._actors.pop()
                self._load.pop(idx, None)
                self._idle_polls = 0
        else:
            self._idle_polls = 0

    @property
    def size(self) -> int:
        return len(self._actors)

    def shutdown(self):
        import ray_tpu_torch

        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001 — already dead
                pass
        # drop load bookkeeping for submissions whose task_done never came
        # (the materialize path is fire-and-forget — see _Pipeline)
        self._by_ref.clear()
        self._load = {i: 0 for i in self._load}


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


def _actor_label(cls) -> str:
    return getattr(cls, "__name__", None) or getattr(
        getattr(cls, "func", None), "__name__", "udf")


def _stage_name(stage) -> str:
    if stage[0] == "tasks":
        ops = stage[1]
        return "->".join(k for k, _ in ops) if ops else "read"
    return f"actors[{_actor_label(stage[1])}]"


class _StageState:
    def __init__(self, stage, idx: int, pool: Optional[AutoScalingActorPool]):
        self.stage = stage
        self.idx = idx
        self.pool = pool
        self.queue: "collections.deque" = collections.deque()
        self.in_flight: Dict[bytes, Any] = {}   # ref id -> (ref, t0, order, est)
        self.bytes_in_flight = 0
        self.stats = OpStats(name=_stage_name(stage))
        self.avg_size = float(_SMALL_OBJECT_EST)
        self._bp_since: Optional[float] = None
        self.named_run = None  # segment-named RemoteFunction, built lazily


class StreamingExecutorV2:
    """Pull-driven scheduling loop with byte budgets (see module doc)."""

    def __init__(self, producers, stages, *, window: int,
                 max_bytes_per_op: Optional[int] = None, tag: str = ""):
        from ray_tpu_torch.data.context import DataContext

        ctx = DataContext.get_current()
        self.window = max(1, window)
        self.max_bytes = max_bytes_per_op or ctx.op_memory_budget_bytes
        self.tag = tag or f"ds-{next(_exec_counter)}"
        self.producers = list(producers)
        from ray_tpu_torch.remote_function import RemoteFunction

        from ray_tpu_torch.data.dataset import _run_chain

        self._run = RemoteFunction(_run_chain)
        stages = list(stages)
        if stages and stages[0][0] == "actors":
            # actor stages take materialized BLOCKS; a callable source
            # materializes through one producer task first
            stages.insert(0, ("tasks", []))
        self.stages: List[_StageState] = []
        for i, st in enumerate(stages):
            pool = None
            if st[0] == "actors":
                _, cls, args, kwargs, conc = st
                lo, hi = conc if isinstance(conc, tuple) else (conc, conc)
                pool = AutoScalingActorPool(cls, args, kwargs, lo, hi)
            self.stages.append(_StageState(st, i, pool))

    # -- submission helpers ---------------------------------------------

    def _submit(self, ss: _StageState, item, order: int):
        if ss.stage[0] == "tasks":
            run = ss.named_run
            if run is None:
                # one span per operator-segment task: the task NAME carries
                # the segment's op chain, so its execution span (and the
                # state API / timeline rows) read "data:read->map" instead
                # of "_run_chain" — built lazily, cached per stage
                run = ss.named_run = self._run.options(
                    name=f"data:{ss.stats.name[:48]}")
            ref = run.remote(item, ss.stage[1])
        else:
            ref = ss.pool.submit(item)
        ss.in_flight[ref._id.binary()] = (ref, time.perf_counter(), order,
                                          ss.avg_size)
        ss.bytes_in_flight += ss.avg_size
        ss.stats.peak_in_flight = max(ss.stats.peak_in_flight,
                                      len(ss.in_flight))
        return ref

    def _harvest(self, timeout: float):
        """Move completed tasks' outputs downstream; returns finals list of
        (order, ref) that completed the LAST stage."""
        import ray_tpu_torch

        all_refs = [v[0] for ss in self.stages for v in ss.in_flight.values()]
        finals = []
        if not all_refs:
            return finals
        ready, _ = ray_tpu_torch.wait(all_refs,
                                num_returns=len(all_refs), timeout=timeout)
        if not ready:
            return finals
        ready_ids = {r._id.binary() for r in ready}
        for ss in self.stages:
            done = [k for k in ss.in_flight if k in ready_ids]
            for k in done:
                ref, t0, order, est = ss.in_flight.pop(k)
                ss.bytes_in_flight -= est
                dt = time.perf_counter() - t0
                ss.stats.blocks += 1
                ss.stats.task_s_total += dt
                ss.stats.task_s_max = max(ss.stats.task_s_max, dt)
                size = _ref_size(ref)
                if size is not None:
                    # EMA of observed output size feeds the byte budget
                    ss.avg_size = 0.7 * ss.avg_size + 0.3 * size
                    ss.stats.bytes_out += size
                else:
                    ss.stats.bytes_out += int(ss.avg_size)
                if ss.pool is not None:
                    ss.pool.task_done(ref)
                nxt = ss.idx + 1
                if nxt < len(self.stages):
                    self.stages[nxt].queue.append((order, ref))
                    self.stages[nxt].stats.peak_queued = max(
                        self.stages[nxt].stats.peak_queued,
                        len(self.stages[nxt].queue))
                else:
                    finals.append((order, ref))
        return finals

    def _admit(self):
        """Admit queued blocks into each stage under the byte budget."""
        now = time.perf_counter()
        for ss in self.stages:
            cap_blocks = self.window if ss.pool is None else max(
                self.window, 2 * ss.pool.size)
            blocked = False
            while ss.queue:
                # always admit ONE block when nothing is in flight — a block
                # larger than the budget must throttle to serial execution,
                # not deadlock the stage
                if ss.in_flight and (
                        len(ss.in_flight) >= cap_blocks
                        or ss.bytes_in_flight + ss.avg_size > self.max_bytes):
                    blocked = True
                    break
                order, item = ss.queue.popleft()
                self._submit(ss, item, order)
            if blocked:
                if ss._bp_since is None:
                    ss._bp_since = now
            elif ss._bp_since is not None:
                ss.stats.backpressure_s += now - ss._bp_since
                ss._bp_since = None
            if ss.pool is not None:
                ss.pool.autoscale(len(ss.queue) + len(ss.in_flight))
                ss.stats.actors_peak = max(ss.stats.actors_peak, ss.pool.size)

    # -- the loop --------------------------------------------------------

    def run(self) -> Iterator[Block]:
        import ray_tpu_torch

        from ray_tpu_torch.util import tracing

        # driver-side execution span: every segment task submitted by this
        # loop chains under it, so one dataset consumption reads as one
        # trace in timeline(). The contextvar is installed only around the
        # submit/harvest region of each scheduling turn — never across a
        # yield, where it would leak into (and mis-parent) whatever else
        # the consumer does between blocks
        exec_sp = tracing.start_manual_span(f"data:execute:{self.tag}")
        t_start = time.perf_counter()
        stats = DatasetStats()
        first = self.stages[0]
        src = collections.deque(enumerate(self.producers))
        out_buf: Dict[int, Any] = {}
        next_out = 0
        emitted = 0
        total = len(self.producers)
        try:
            while emitted < total:
                with tracing.installed_span(exec_sp):
                    # source admission rides the same budget as every stage
                    # and is additionally gated on delivery progress so a
                    # straggler at a low order can't pile finished blocks
                    # into out_buf (constant-footprint contract); an empty
                    # stage always admits one block even over budget
                    while src and src[0][0] - next_out < 2 * self.window and (
                            not first.in_flight
                            or (len(first.in_flight) < self.window
                                and first.bytes_in_flight + first.avg_size
                                <= self.max_bytes)):
                        order, producer = src.popleft()
                        self._submit(first, producer, order)
                    for order, ref in self._harvest(timeout=0.05):
                        out_buf[order] = ref
                    self._admit()
                # in-order delivery; the pull is the final backpressure
                while next_out in out_buf:
                    ref = out_buf.pop(next_out)
                    block = ray_tpu_torch.get(ref, timeout=600)
                    size = _ref_size(ref)
                    stats.output_bytes += (
                        size if size is not None else _SMALL_OBJECT_EST)
                    stats.output_blocks += 1
                    del ref
                    next_out += 1
                    emitted += 1
                    yield block
        finally:
            for ss in self.stages:
                if ss._bp_since is not None:
                    ss.stats.backpressure_s += (
                        time.perf_counter() - ss._bp_since)
                if ss.pool is not None:
                    ss.pool.shutdown()
            stats.ops = [ss.stats for ss in self.stages]
            stats.wall_s = time.perf_counter() - t_start
            record_stats(self.tag, stats)
            self.last_stats = stats
            tracing.end_manual_span(exec_sp, blocks=stats.output_blocks)

    def __iter__(self) -> Iterator[Block]:
        return self.run()
