"""Physical planner: compile an optimized logical plan into executable
segments, and execute them.

Reference surface: python/ray/data/_internal/planner/planner.py:230 (logical
op -> physical operator compilation) + execution/operators/* (task-pool map,
actor-pool map, limit, all-to-all). Here a plan compiles to a list of
`Segment`s:

    Segment = (source producers, pipeline stages, stream-order row limit)

One segment is a fully streamable pipeline: ONE fused remote task per
source block (plus actor-pool stages), executed by StreamingExecutorV2 for
consumption or `_Pipeline` for materialization. Segment boundaries are
stream-order limit FENCES: a row-count-changing op chained after `limit(n)`
lands in the NEXT segment, so it only ever observes rows within the global
budget (ADVICE r5 #1) — the planner derives the fence from the plan shape
instead of the old hand-wired `_limit_src` special case.

A limited segment always executes as a COVERING PREFIX: producers are
submitted in stream-order windows and submission stops once the row budget
is met, so `limit(k)` over B blocks runs O(blocks-needed) tasks.

All-to-all ops (sort/shuffle/groupby/join/zip/repartition) execute to block
refs through the node executors at the bottom of this module (moved from
Dataset methods); their results cache on the logical node, so every dataset
sharing the subtree reuses the shuffle.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data._logical import operators as ops_mod
from ray_tpu_torch.data.block import (
    Block,
    block_concat,
    block_num_rows,
    block_rows,
    block_slice,
    rows_to_block,
)

_Stage = Tuple

def _count_meta_shortcut(kind: str) -> None:
    try:
        from ray_tpu_torch.util.metrics import get_or_create_counter

        get_or_create_counter(
            "rt_data_meta_shortcuts_total",
            "Dataset queries answered from metadata with zero block "
            "reads", tag_keys=("kind",)).inc(1, tags={"kind": kind})
    except Exception:  # noqa: BLE001 — metrics must never fail a query
        pass


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


class _DeferredSource:
    """A segment source that resolves to block refs on first execution
    (all-to-all node outputs, baked union branches). explain() renders the
    label without resolving."""

    def __init__(self, label: str, thunk: Optional[Callable] = None):
        self.label = label
        self.thunk = thunk

    def resolve(self) -> List[Any]:
        if self.thunk is None:
            raise RuntimeError(
                f"deferred source {self.label!r} compiled for explain only")
        return self.thunk()


class Segment:
    """One streamable pipeline: source -> stages -> (limit cut)."""

    __slots__ = ("source", "stages", "limit")

    def __init__(self, source=None, stages: Optional[List[_Stage]] = None,
                 limit: Optional[int] = None):
        self.source = source  # list | _DeferredSource | None (stream-fed)
        self.stages: List[_Stage] = list(stages or [])
        self.limit = limit

    def trailing_ops(self) -> List:
        if not self.stages or self.stages[-1][0] != "tasks":
            self.stages.append(("tasks", []))
        return self.stages[-1][1]

    def has_actor_stage(self) -> bool:
        return any(st[0] == "actors" for st in self.stages)

    def resolve_source(self) -> List[Any]:
        if isinstance(self.source, _DeferredSource):
            return self.source.resolve()
        return list(self.source or [])


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------


def compile_plan(root: ops_mod.LogicalOp, *,
                 allow_execute: bool = True) -> List[Segment]:
    """Compile a (logical) plan to segments. With allow_execute=False the
    compile is side-effect-free — all-to-all sources and limited union
    branches stay symbolic (for explain()). The linear chain is peeled
    ITERATIVELY (plans grow one node per transform call, so chains can be
    deeper than the recursion limit); only Union branches recurse."""
    chain: List[ops_mod.LogicalOp] = []
    node = root
    while isinstance(node, (ops_mod.AbstractMap, ops_mod.ActorPoolMap,
                            ops_mod.Limit)):
        chain.append(node)
        node = node.input

    if isinstance(node, ops_mod.Read):
        segs = [Segment(list(node.datasource.producers()))]
    elif isinstance(node, ops_mod.InputBlocks):
        segs = [Segment(list(node.refs))]
    elif isinstance(node, ops_mod.Union):
        producers: List[Any] = []
        for branch in node.inputs:
            bsegs = compile_plan(branch, allow_execute=allow_execute)
            producers.extend(
                _branch_producers(bsegs, allow_execute=allow_execute))
        segs = [Segment(producers)]
    elif isinstance(node, ops_mod.Materializing):
        if allow_execute:
            src = _DeferredSource(node.label(),
                                  lambda n=node: execute_node(n))
        else:
            src = _DeferredSource(node.label())
        segs = [Segment(src)]
    else:
        raise TypeError(f"cannot compile logical node {node!r}")

    for nd in reversed(chain):
        last = segs[-1]
        if isinstance(nd, ops_mod.ActorPoolMap):
            if last.limit is None:
                last.stages.append(nd.stage())
            else:
                segs.append(Segment(None, [nd.stage()]))
        elif isinstance(nd, ops_mod.Limit):
            if last.limit is None:
                last.limit = nd.n
            else:
                # a second cut of an already-cut stream (an intervening
                # row-preserving op kept it in this segment)
                last.limit = min(last.limit, nd.n)
            # per-block cap pushes down into the fused task chain
            last.trailing_ops().append(("limit", nd.n))
        else:  # AbstractMap
            fused = nd.fused_ops()
            if last.limit is not None:
                if nd.row_preserving:
                    # 1:1 ops may ride the capped chain past a limit: the
                    # per-block cap + the surface stream cut keep the
                    # output exact, and a row-preserving op can't leak
                    # rows past the global budget
                    last.trailing_ops().extend(fused)
                else:
                    # stream-order fence: this op only sees the capped
                    # stream
                    segs.append(Segment(None, [("tasks", list(fused))]))
            else:
                # one stage per LOGICAL node: fusion is the OperatorFusion
                # rule's job (it emits multi-op FusedMap nodes), not the
                # compiler's — with the optimizer off each op really is
                # its own task hop, which is what bench_data.py A/Bs
                last.stages.append(("tasks", list(fused)))
    return segs


def _branch_producers(segs: List[Segment], *,
                      allow_execute: bool) -> List[Any]:
    """A union branch as plain producers: a single task-only unlimited
    segment rides as closures (its pending chain bakes into each
    producer); anything with a limit fence or actor stage bakes to refs."""
    import functools

    from ray_tpu_torch.data.dataset import _run_chain

    if (len(segs) == 1 and segs[0].limit is None
            and not segs[0].has_actor_stage()
            and not isinstance(segs[0].source, _DeferredSource)):
        seg = segs[0]
        chain_ops = [op for st in seg.stages for op in st[1]]
        src = list(seg.source or [])
        if not chain_ops:
            return src
        return [functools.partial(_run_chain, p, chain_ops) for p in src]
    if not allow_execute:
        return [_DeferredSource("union-branch[baked]")]
    refs, _ = execute_to_refs(segs, tag=None)
    return refs


# ---------------------------------------------------------------------------
# execution: materialize path
# ---------------------------------------------------------------------------


def _truncate_block(block: Block, n: int) -> Block:
    # module-level so RemoteFunction(_truncate_block) pickles by reference
    return block_slice(block, 0, n)


def _row_counts(refs: List[Any]) -> List[int]:
    import ray_tpu_torch
    from ray_tpu_torch.remote_function import RemoteFunction

    count = RemoteFunction(block_num_rows)
    return ray_tpu_torch.get([count.remote(r) for r in refs], timeout=600)


class _Pipeline:
    """Executable form of one segment: source producers + stage list.
    Submits ONE chained ref pipeline per source block; actor stages route
    through their pool.

    Pools here are FIRE-AND-FORGET: the caller submits every block before
    any resolves and shuts the pools down right after its barrier, so no
    task_done feedback flows and least-loaded routing degrades to
    submission-count balancing (which is uniform). The streaming executor
    (_executor.StreamingExecutorV2) is the path with live load feedback."""

    def __init__(self, producers, stages: List[_Stage]):
        from ray_tpu_torch.data._executor import AutoScalingActorPool
        from ray_tpu_torch.data.dataset import _run_chain
        from ray_tpu_torch.remote_function import RemoteFunction

        self.producers = producers
        self.stages = stages
        self._run = RemoteFunction(_run_chain)
        self._pools: List[Optional[AutoScalingActorPool]] = []
        for st in stages:
            if st[0] == "actors":
                _, cls, args, kwargs, size = st
                if isinstance(size, tuple):  # (min, max) autoscaling spec
                    size = size[1]
                # fixed-size pool (the materialize path has no scheduling
                # loop to drive scaling); the streaming executor autoscales
                self._pools.append(
                    AutoScalingActorPool(cls, args, kwargs, size, size))
            else:
                self._pools.append(None)

    def submit_block(self, producer):
        """Chain the whole stage pipeline for one source block; returns
        the final block ref. No barriers — downstream stages start as soon
        as their input ref resolves."""
        from ray_tpu_torch._private.core_worker import ObjectRef

        ref = producer
        materialized = isinstance(ref, ObjectRef)
        for st, pool in zip(self.stages, self._pools):
            if st[0] == "tasks":
                if st[1] or not materialized:
                    ref = self._run.remote(ref, st[1])
                    materialized = True
            else:
                if not materialized:
                    # actor stage first: actors take BLOCKS, so a callable
                    # source materializes through one producer task
                    ref = self._run.remote(ref, [])
                    materialized = True
                ref = pool.submit(ref)
        if not materialized:
            ref = self._run.remote(ref, [])
        return ref

    def has_pools(self) -> bool:
        return any(p is not None for p in self._pools)

    def shutdown(self):
        for p in self._pools:
            if p is not None:
                p.shutdown()


def _pipeline_refs(source: List[Any], stages: List[_Stage]) -> List[Any]:
    import ray_tpu_torch
    from ray_tpu_torch._private.core_worker import ObjectRef

    stages = stages or [("tasks", [])]
    if all(st == ("tasks", []) for st in stages) and all(
            isinstance(p, ObjectRef) for p in source):
        return list(source)  # already-computed blocks, nothing to run
    pipeline = _Pipeline(source, stages)
    refs = [pipeline.submit_block(p) for p in source]
    if pipeline.has_pools():
        # actor pools must outlive their in-flight blocks
        ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=None)
    pipeline.shutdown()
    return refs


def _limited_prefix_refs(source: List[Any], stages: List[_Stage],
                         n: int) -> List[Any]:
    """Execute a limited segment over the shortest source prefix whose
    rows cover `n`, in submission windows: count each window's output and
    stop before the next window once the budget is met. Blocks past the
    boundary are never submitted — limit(k) over B blocks runs
    O(blocks-needed) tasks, not B."""
    from ray_tpu_torch.data.context import DataContext
    from ray_tpu_torch.remote_function import RemoteFunction

    window = max(1, DataContext.get_current().streaming_block_window)
    cut = RemoteFunction(_truncate_block)
    pipeline = _Pipeline(source, stages or [("tasks", [])])
    out: List[Any] = []
    remaining = n
    try:
        for start in range(0, len(source), window):
            if remaining <= 0:
                break
            batch = [
                pipeline.submit_block(p)
                for p in source[start:start + window]
            ]
            # the count barrier doubles as the pools'
            # must-outlive-in-flight-blocks barrier per window
            counts = _row_counts(batch)
            for ref, c in zip(batch, counts):
                if remaining <= 0:
                    break  # computed past the boundary; dropped
                if c <= remaining:
                    out.append(ref)
                    remaining -= c
                else:
                    out.append(cut.remote(ref, remaining))
                    remaining = 0
    finally:
        # safe here: every pool-produced block resolved at its window's
        # count barrier; the boundary cut is a plain task over an
        # already-computed ref, so it survives pool shutdown
        pipeline.shutdown()
    return out


def _segment_name(seg: Segment) -> str:
    from ray_tpu_torch.data._executor import _stage_name

    names = [_stage_name(st) for st in seg.stages] or ["read"]
    return " | ".join(names)


def execute_to_refs(segments: List[Segment], *, tag: Optional[str] = ""):
    """Materialize a compiled plan: run each segment in order (a limited
    segment executes its covering prefix), feeding the next segment's
    pipeline with the previous one's refs. Returns (refs, DatasetStats)
    — per-segment op rows threaded into the stats/metrics plane."""
    from ray_tpu_torch.data._executor import DatasetStats, OpStats, record_stats

    t0 = time.perf_counter()
    stats = DatasetStats()
    refs: List[Any] = []
    for i, seg in enumerate(segments):
        seg_t0 = time.perf_counter()
        source = seg.resolve_source() if i == 0 else refs
        if seg.limit is not None:
            refs = _limited_prefix_refs(source, seg.stages, seg.limit)
        else:
            refs = _pipeline_refs(source, seg.stages)
        op = OpStats(name=_segment_name(seg))
        op.blocks = len(refs)
        op.task_s_total = time.perf_counter() - seg_t0
        stats.ops.append(op)
    stats.output_blocks = len(refs)
    stats.wall_s = time.perf_counter() - t0
    if tag is not None:
        from ray_tpu_torch.data._executor import _exec_counter

        record_stats(tag or f"ds-{next(_exec_counter)}", stats)
    return refs, stats


def plan_refs(node: ops_mod.LogicalOp) -> List[Any]:
    """Execute an arbitrary subplan to block refs."""
    return execute_to_refs(compile_plan(node), tag=None)[0]


# ---------------------------------------------------------------------------
# execution: streaming path
# ---------------------------------------------------------------------------


def _cut_stream(blocks, budget: Optional[int]):
    """Stream-order global limit: truncate the boundary block and stop
    pulling upstream once the budget is spent."""
    if budget is None:
        yield from blocks
        return
    for block in blocks:
        if budget <= 0:
            return
        rows = block_num_rows(block)
        if rows > budget:
            yield _truncate_block(block, budget)
            return
        budget -= rows
        yield block


def iter_plan(segments: List[Segment], *, window: int,
              holder: Optional[dict] = None):
    """Streaming consumption of a compiled plan. Segment 0 streams through
    StreamingExecutorV2 under its byte budgets; post-fence segments apply
    their (task-only) chains to the capped stream. A post-fence actor
    stage can't run driver-side, so that rare shape falls back to the
    materialize path."""
    import ray_tpu_torch

    from ray_tpu_torch.data.dataset import _apply_ops

    if any(seg.has_actor_stage() for seg in segments[1:]):
        refs, stats = execute_to_refs(segments)
        if holder is not None:
            holder["stats"] = stats
        yield from _cut_stream(
            (ray_tpu_torch.get(r, timeout=600) for r in refs), None)
        return

    seg0 = segments[0]
    source = seg0.resolve_source()
    from ray_tpu_torch.data._executor import StreamingExecutorV2

    ex = StreamingExecutorV2(source, seg0.stages or [("tasks", [])],
                             window=window)
    try:
        stream = _cut_stream(iter(ex), seg0.limit)
        for seg in segments[1:]:
            chain_ops = [op for st in seg.stages for op in st[1]]
            stream = _cut_stream(
                (_apply_ops(b, chain_ops) for b in stream), seg.limit)
        yield from stream
    finally:
        if holder is not None:
            holder["stats"] = getattr(ex, "last_stats", None)


# ---------------------------------------------------------------------------
# explain rendering
# ---------------------------------------------------------------------------


def describe_segments(segments: List[Segment]) -> List[str]:
    from ray_tpu_torch.data._executor import _actor_label

    lines: List[str] = []
    for i, seg in enumerate(segments):
        if i == 0:
            if isinstance(seg.source, _DeferredSource):
                lines.append(f"  source[{seg.source.label}]")
            else:
                n = len(seg.source or [])
                deferred = sum(
                    1 for p in (seg.source or [])
                    if isinstance(p, _DeferredSource))
                lines.append(
                    f"  source[{n} blocks"
                    + (f", {deferred} baked branch(es)" if deferred else "")
                    + "]")
        for st in seg.stages:
            if st[0] == "tasks":
                names = [k for k, _ in st[1]] or ["read"]
                lines.append(f"  tasks[fused: {' -> '.join(names)}]")
            else:
                lines.append(f"  actors[{_actor_label(st[1])}, "
                             f"concurrency={st[4]}]")
        if seg.limit is not None:
            if i < len(segments) - 1:
                lines.append(
                    f"  limit[stream-order fence: {seg.limit} rows]")
            else:
                lines.append(f"  limit[{seg.limit} rows]")
    return lines


# ---------------------------------------------------------------------------
# metadata shortcuts (zero data blocks read)
# ---------------------------------------------------------------------------


def resolve_count(node: ops_mod.LogicalOp) -> Optional[int]:
    """Row count from plan structure + datasource metadata (parquet
    footers, range/from_items arithmetic) — None means 'must execute'.
    Iterative descent (chains can out-depth the recursion limit); only
    Union branches recurse."""
    limit: Optional[int] = None
    while True:
        if isinstance(node, ops_mod.Read):
            base = node.datasource.count_rows()
            break
        if isinstance(node, ops_mod.Limit):
            limit = node.n if limit is None else min(limit, node.n)
            node = node.input
            continue
        if isinstance(node, ops_mod.AbstractMap):
            if not node.row_preserving:
                return None
            node = node.input
            continue
        if isinstance(node, ops_mod.Union):
            total = 0
            for branch in node.inputs:
                c = resolve_count(branch)
                if c is None:
                    return None
                total += c
            base = total
            break
        if isinstance(node, (ops_mod.Repartition, ops_mod.Sort,
                             ops_mod.RandomShuffle)):
            node = node.input
            continue
        return None
    if base is None:
        return None
    return base if limit is None else min(base, limit)


def resolve_schema(node: ops_mod.LogicalOp) -> Optional[Dict[str, str]]:
    projects: List[List[str]] = []  # collected outermost-first
    while True:
        if isinstance(node, ops_mod.Read):
            sch = node.datasource.schema()
            break
        if isinstance(node, ops_mod.Project):
            projects.append(node.columns)
            node = node.input
            continue
        if isinstance(node, (ops_mod.Filter, ops_mod.Limit,
                             ops_mod.Repartition, ops_mod.Sort,
                             ops_mod.RandomShuffle)):
            node = node.input
            continue
        if isinstance(node, ops_mod.Union):
            schemas = [resolve_schema(b) for b in node.inputs]
            if all(s is not None for s in schemas) and all(
                    s == schemas[0] for s in schemas):
                sch = schemas[0]
                break
            return None
        return None
    if sch is None:
        return None
    for cols in reversed(projects):  # apply innermost projection first
        try:
            sch = {c: sch[c] for c in cols}
        except KeyError:
            return None
    return sch


def resolve_num_blocks(node: ops_mod.LogicalOp) -> Optional[int]:
    while isinstance(node, (ops_mod.AbstractMap, ops_mod.ActorPoolMap,
                            ops_mod.Limit)):
        node = node.input
    if isinstance(node, ops_mod.Read):
        return node.datasource.num_blocks()
    if isinstance(node, ops_mod.InputBlocks):
        return len(node.refs)
    if isinstance(node, ops_mod.Union):
        total = 0
        for branch in node.inputs:
            c = resolve_num_blocks(branch)
            if c is None:
                return None
            total += c
        return total
    if isinstance(node, ops_mod.Repartition):
        return node.num_blocks
    return None


def projection_folded(node: ops_mod.LogicalOp) -> bool:
    """True when an optimized plan carries no residual Project AND some
    datasource accepted a column pushdown — i.e. projecting actually
    narrows the read instead of adding a per-block copy."""
    has_project = any(
        isinstance(n, ops_mod.Project)
        or (isinstance(n, ops_mod.FusedMap)
            and any(k == "project" for k, _ in n.ops))
        for n in ops_mod.walk(node))
    pushed = any(
        isinstance(n, ops_mod.Read) and n.datasource.columns
        for n in ops_mod.walk(node))
    return pushed and not has_project


def record_metadata_stats(dataset_tag: str, kind: str, detail: str):
    """A query answered with zero data blocks read still shows up on the
    stats/metrics plane (the test surface for 'no map tasks ran')."""
    from ray_tpu_torch.data._executor import (DatasetStats, OpStats, _exec_counter,
                                        record_stats)

    st = DatasetStats(ops=[OpStats(name=f"metadata[{kind}: {detail}]")])
    record_stats(dataset_tag or f"ds-{next(_exec_counter)}", st,
                 emit_metrics=False)
    _count_meta_shortcut(kind)
    return st


# ---------------------------------------------------------------------------
# all-to-all node executors (moved from Dataset methods)
# ---------------------------------------------------------------------------


def _stable_key_hash(v) -> int:
    """Deterministic cross-process key hash for shuffles/joins. NOT hash():
    str hashing is per-process randomized. Numeric keys canonicalize first
    (1, 1.0, np.int64(1), True are dict-equal and must co-partition)."""
    import hashlib as _hl

    if hasattr(v, "item"):
        v = v.item()
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    d = _hl.blake2b(repr(v).encode(), digest_size=8).digest()
    return int.from_bytes(d, "little")


def _shuffle_partitions(refs, requested: Optional[int] = None) -> int:
    """Partition count for shuffle-class ops (sort/shuffle/groupby/join).

    Spill-aware sizing (reference: the shuffle partitioning in
    execution/operators/hash_shuffle + resource_manager budgets): target
    ~shuffle_target_partition_bytes per partition from SAMPLED block sizes,
    capped at shuffle_max_partitions — without the cap, B input blocks x
    B partitions costs B^2 return refs and B-arg merge tasks, which is what
    falls over at hundreds of blocks, not the O(N) data movement."""
    if requested:
        return max(1, int(requested))
    n = len(refs)
    if n <= 1:
        return max(1, n)
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    target = ctx.shuffle_target_partition_bytes
    cap = ctx.shuffle_max_partitions
    from ray_tpu_torch.data._executor import _ref_size

    # strided sample: leading blocks are often unrepresentative (header /
    # remainder blocks from readers)
    probe = refs[::max(1, n // 8)][:8]
    sizes = [sz for sz in (_ref_size(r) for r in probe) if sz is not None]
    if sizes:
        est_total = (sum(sizes) / len(sizes)) * n
        want = -(-int(est_total) // max(1, target))
        return max(1, min(n, cap, max(want, 1)))
    return max(1, min(n, cap))


def _slice_row_range(lo: int, hi: int, block_starts, *blocks) -> Block:
    """Rows [lo, hi) of a virtual concatenation, given each block's global
    start offset (shared by repartition and zip alignment)."""
    parts = []
    for s, b in zip(block_starts, blocks):
        n = block_num_rows(b)
        a, z = max(lo, s), min(hi, s + n)
        if z > a:
            parts.append(block_slice(b, a - s, z - s))
    return block_concat(parts) if parts else rows_to_block([])


def _sort_block(block: Block, key: str, descending: bool) -> Block:
    if isinstance(block, dict):
        col = np.asarray(block[key])
        order = np.argsort(col, kind="stable")
        if descending:
            order = order[::-1]
        return {c: np.asarray(v)[order] for c, v in block.items()}
    rows = sorted(block_rows(block), key=lambda r: r[key], reverse=descending)
    return rows_to_block(rows)


def execute_node(node: ops_mod.Materializing) -> List[Any]:
    """Execute an all-to-all node to block refs (cached on the node)."""
    cache = node._cache
    if "refs" in cache:
        return cache["refs"]
    if isinstance(node, ops_mod.Repartition):
        refs = execute_repartition(plan_refs(node.input), node.num_blocks)
    elif isinstance(node, ops_mod.Sort):
        refs = execute_sort(plan_refs(node.input), node.key, node.descending)
    elif isinstance(node, ops_mod.RandomShuffle):
        refs = execute_random_shuffle(plan_refs(node.input), node.seed)
    elif isinstance(node, ops_mod.GroupByAgg):
        refs = execute_groupby(plan_refs(node.input), node.key, node.agg,
                               node.col)
    elif isinstance(node, ops_mod.Join):
        refs = execute_join(plan_refs(node.inputs[0]),
                            plan_refs(node.inputs[1]), node.on, node.how,
                            node.num_partitions)
    elif isinstance(node, ops_mod.Zip):
        refs = execute_zip(plan_refs(node.inputs[0]),
                           plan_refs(node.inputs[1]))
    else:
        raise TypeError(f"no executor for {node!r}")
    cache["refs"] = refs
    return refs


def execute_repartition(refs: List[Any], num_blocks: int) -> List[Any]:
    """Rebalance rows into `num_blocks` equal blocks. Each output task
    receives only the input blocks overlapping its row range — O(N) total
    movement, not all-blocks-to-every-task."""
    from ray_tpu_torch.remote_function import RemoteFunction

    counts = _row_counts(refs)
    starts = list(np.cumsum([0] + counts))  # global start offset per block
    total = starts[-1]

    run = RemoteFunction(_slice_row_range)
    new_refs = []
    for i in range(num_blocks):
        lo, hi = (total * i) // num_blocks, (total * (i + 1)) // num_blocks
        overlap = [
            j for j in range(len(refs))
            if starts[j] < hi and starts[j] + counts[j] > lo
        ]
        new_refs.append(run.remote(
            lo, hi, [starts[j] for j in overlap], *[refs[j] for j in overlap]
        ))
    return new_refs


def execute_random_shuffle(refs: List[Any], seed) -> List[Any]:
    """Global random shuffle. Two-stage push shuffle as in the reference's
    shuffle ops: each input block scatters its rows into k partitions (one
    task, k returns); each output concatenates and permutes its k incoming
    parts — O(N) total movement."""
    from ray_tpu_torch.remote_function import RemoteFunction

    k = _shuffle_partitions(refs)
    if len(refs) <= 1:
        return list(refs)

    def _scatter(sd, j: int, k: int, block):
        rng = np.random.default_rng(None if sd is None else sd * 1_000_003 + j)
        n = block_num_rows(block)
        assign = rng.integers(0, k, size=n)
        if isinstance(block, dict):
            return tuple(
                {c: v[assign == i] for c, v in block.items()} for i in range(k)
            )
        items = list(block)
        return tuple(
            [items[t] for t in np.flatnonzero(assign == i)] for i in range(k)
        )

    def _merge(sd, i: int, *parts):
        whole = block_concat(list(parts))
        rng = np.random.default_rng(None if sd is None else sd * 7_000_003 + i)
        n = block_num_rows(whole)
        perm = rng.permutation(n)
        if isinstance(whole, dict):
            return {c: v[perm] for c, v in whole.items()}
        return [whole[j] for j in perm]

    merge = RemoteFunction(_merge)
    if k == 1:
        # size-driven single partition: permute everything in one task
        return [merge.remote(seed, 0, *refs)]
    scatter = RemoteFunction(_scatter).options(num_returns=k)
    # EVERY input block scatters (k is the partition count, which may
    # be smaller than the block count under spill-aware sizing)
    partitions = [
        scatter.remote(seed, j, k, refs[j]) for j in range(len(refs))
    ]
    return [
        merge.remote(seed, i, *[p[i] for p in partitions])
        for i in range(k)
    ]


def _sort_single_partition(refs, key, descending) -> List[Any]:
    """One global sort task (a per-block sort would not be a global order
    when several blocks feed one partition)."""
    from ray_tpu_torch.remote_function import RemoteFunction

    def _sort_all(*blocks):
        return _sort_block(block_concat(list(blocks)), key, descending)

    return [RemoteFunction(_sort_all).remote(*refs)]


def execute_sort(refs: List[Any], key: str, descending: bool) -> List[Any]:
    """Distributed sort: sample key range → range-partition scatter →
    per-partition sort (reference: data sort ops; the classic TeraSort
    shape, O(N) movement + parallel partition sorts)."""
    import ray_tpu_torch
    from ray_tpu_torch.remote_function import RemoteFunction

    k = _shuffle_partitions(refs)
    if not refs:
        return []
    if k == 1:
        # no range bounds needed — skip the sampling round-trip
        return _sort_single_partition(refs, key, descending)

    def _sample(block):
        col = np.asarray(block[key]) if isinstance(block, dict) else (
            np.asarray([r[key] for r in block_rows(block)])
        )
        if col.size == 0:
            return col
        take = min(64, col.size)
        idx = np.random.default_rng(0).choice(col.size, take, replace=False)
        return col[idx]

    samples = np.concatenate([
        s for s in ray_tpu_torch.get(
            [RemoteFunction(_sample).remote(r) for r in refs], timeout=600)
        if s.size
    ])
    if samples.size == 0:
        return _sort_single_partition(refs, key, descending)
    # positional quantiles, not np.quantile: sort keys may be strings
    # (any sortable dtype) and only order matters for range bounds
    srt = np.sort(samples)
    bounds = srt[[
        min(srt.size - 1, max(0, (srt.size * i) // k)) for i in range(1, k)
    ]]

    def _scatter(block, bounds):
        col = np.asarray(block[key]) if isinstance(block, dict) else (
            np.asarray([r[key] for r in block_rows(block)])
        )
        assign = np.searchsorted(bounds, col, side="right")
        n_parts = len(bounds) + 1
        if isinstance(block, dict):
            return tuple(
                {c: np.asarray(v)[assign == i] for c, v in block.items()}
                for i in range(n_parts)
            )
        items = list(block)
        return tuple(
            [items[t] for t in np.flatnonzero(assign == i)]
            for i in range(n_parts)
        )

    def _merge_sort(*parts):
        return _sort_block(block_concat(list(parts)), key, descending)

    scatter = RemoteFunction(_scatter).options(num_returns=k)
    partitions = [scatter.remote(r, bounds) for r in refs]
    order = range(k - 1, -1, -1) if descending else range(k)
    # fan-in over EVERY scatter (len(refs)), not range(k): k may be
    # size-driven < len(refs)
    return [
        RemoteFunction(_merge_sort).remote(*[p[i] for p in partitions])
        for i in order
    ]


# per-group leaf computed inside one partition: hash partitioning puts ALL
# rows of a group in the same partition, so no cross-partition combine is
# needed — mean included
GROUP_AGGS = {
    "count": len,
    "sum": lambda vals: np.sum(vals).item(),
    "min": lambda vals: np.min(vals).item(),
    "max": lambda vals: np.max(vals).item(),
    "mean": lambda vals: float(np.mean(vals)),
}


def execute_groupby(refs: List[Any], key: str, agg: str,
                    col: Optional[str]) -> List[Any]:
    """Hash-partitioned group-by + aggregate (reference: data groupby with
    hash_shuffle aggregate operators). Keys scatter to k partitions by
    hash; each partition aggregates its groups independently."""
    from ray_tpu_torch.remote_function import RemoteFunction

    if not refs:
        return []
    k = _shuffle_partitions(refs)

    def _scatter(block, k):
        keys = (np.asarray(block[key]) if isinstance(block, dict)
                else np.asarray([r[key] for r in block_rows(block)]))
        assign = np.asarray(
            [_stable_key_hash(x) % k for x in keys.tolist()])
        if isinstance(block, dict):
            return tuple(
                {c: np.asarray(v)[assign == i] for c, v in block.items()}
                for i in range(k)
            )
        items = list(block)
        return tuple(
            [items[t] for t in np.flatnonzero(assign == i)]
            for i in range(k)
        )

    def _agg_partition(agg, col, *parts):
        whole = block_concat(list(parts))
        groups: Dict[Any, list] = {}
        for r in block_rows(whole):
            groups.setdefault(r[key], []).append(
                r[col] if col is not None else 1
            )
        leaf = GROUP_AGGS[agg]
        out_name = f"{agg}({col})" if col else "count()"
        return rows_to_block([
            {key: gk, out_name: leaf(vals)} for gk, vals in groups.items()
        ])

    agg_fn = RemoteFunction(_agg_partition)
    if k == 1:
        # no scatter needed — but EVERY block feeds the one partition
        # (k may be size-driven < len(refs))
        return [agg_fn.remote(agg, col, *refs)]
    scatter = RemoteFunction(_scatter).options(num_returns=k)
    partitions = [scatter.remote(r, k) for r in refs]
    # fan-in over EVERY scatter (len(refs) of them), not range(k): k may
    # be size-driven < len(refs)
    return [
        agg_fn.remote(agg, col, *[p[i] for p in partitions])
        for i in range(k)
    ]


def execute_join(left: List[Any], right: List[Any], on: str, how: str,
                 num_partitions: Optional[int]) -> List[Any]:
    """Distributed hash join on column `on` (reference: the data join
    operator / hash_shuffle): both sides scatter rows by hash(key) into
    k partitions (one task per block, k returns), then one task per
    partition builds a hash table from the left rows and probes with the
    right — O(N) movement, k-way parallel joins."""
    from ray_tpu_torch.remote_function import RemoteFunction

    # size BOTH sides: a huge few-block side must not collapse the join
    # because the other side has more (tiny) blocks
    k = (int(num_partitions) if num_partitions
         else max(_shuffle_partitions(left), _shuffle_partitions(right)))

    def _scatter(block, k):
        rows = list(block_rows(block))
        parts: List[List[Any]] = [[] for _ in range(k)]
        for r in rows:
            parts[_stable_key_hash(r[on]) % k].append(r)
        return tuple(rows_to_block(p) for p in parts)

    def _join_partition(n_left, *parts):
        lrows = [r for b in parts[:n_left] for r in block_rows(b)]
        rrows = [r for b in parts[n_left:] for r in block_rows(b)]
        table: Dict[Any, List[Any]] = {}
        for r in rrows:
            table.setdefault(r[on], []).append(r)
        out = []
        for lr in lrows:
            matches = table.get(lr[on])
            if matches:
                for rr in matches:
                    merged = dict(lr)
                    for ck, cv in rr.items():
                        if ck != on:
                            merged[ck if ck not in merged
                                   else f"{ck}_1"] = cv
                    out.append(merged)
            elif how == "left":
                out.append(dict(lr))
        return rows_to_block(out)

    joiner = RemoteFunction(_join_partition)
    if k == 1:
        # num_returns=1 .remote() stores the 1-tuple whole; skip the
        # scatter and hand the raw block refs to the join task (advisor r3)
        return [joiner.remote(len(left), *left, *right)]
    scatter = RemoteFunction(_scatter).options(num_returns=k)
    lparts = [scatter.remote(r, k) for r in left]
    rparts = [scatter.remote(r, k) for r in right]
    return [
        joiner.remote(
            len(lparts),
            *[lp[i] for lp in lparts],
            *[rp[i] for rp in rparts],
        )
        for i in range(k)
    ]


def execute_zip(left: List[Any], right: List[Any]) -> List[Any]:
    """Column-wise zip of two equal-row-count block lists: the right side
    is range-repartitioned to the left's block boundaries, then each
    aligned pair merges columns in one task (duplicate names get a _1
    suffix)."""
    from ray_tpu_torch.remote_function import RemoteFunction

    counts = _row_counts(left)
    r_counts = _row_counts(right)
    if sum(counts) != sum(r_counts):
        raise ValueError(
            f"zip needs equal row counts: {sum(counts)} vs {sum(r_counts)}")
    r_starts = list(np.cumsum([0] + r_counts))

    def _zip_blocks(a, b):
        if not isinstance(a, dict) or not isinstance(b, dict):
            return [
                (ra, rb) for ra, rb in zip(block_rows(a), block_rows(b))
            ]
        out = dict(a)
        for k, v in b.items():
            out[k if k not in out else f"{k}_1"] = v
        return out

    slicer = RemoteFunction(_slice_row_range)
    zipper = RemoteFunction(_zip_blocks)
    new_refs = []
    lo = 0
    for ref, n in zip(left, counts):
        hi = lo + n
        overlap = [
            j for j in range(len(right))
            if r_starts[j] < hi and r_starts[j] + r_counts[j] > lo
        ]
        aligned = slicer.remote(
            lo, hi, [r_starts[j] for j in overlap],
            *[right[j] for j in overlap])
        new_refs.append(zipper.remote(ref, aligned))
        lo = hi
    return new_refs
