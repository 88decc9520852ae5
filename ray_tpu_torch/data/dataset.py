"""Dataset: lazy, distributed, block-based data pipelines over a logical
query plan.

Reference surface: python/ray/data/dataset.py:203 (map/map_batches/filter/
flat_map/split/iter_batches/take/count) + the logical planning stack
(`_internal/logical/` operators and rules, `_internal/planner/planner.py`)
executed by the streaming executor
(python/ray/data/_internal/execution/streaming_executor.py:106).

A redesign instead of a port:
- a Dataset holds a LOGICAL PLAN (ray_tpu_torch/data/_logical/operators.py) it
  never mutates: every transform stacks a node. Consumption optimizes the
  plan (rules to fixpoint: operator fusion, limit pushdown, projection and
  predicate pushdown into datasources — see _logical/rules.py), compiles
  it to streamable segments (_logical/planner.py), and executes ONE fused
  remote task per source block, in parallel across the cluster.
- limit semantics come from the planner, not special cases: a per-block
  cap fuses into the task chain, the global cut is stream-order, a
  row-count-changing op after `limit(n)` lands behind a fence segment (it
  never observes rows beyond the budget — ADVICE r5 #1), and a limited
  plan executes only the covering producer prefix.
- `count()`/`schema()`/`num_blocks()` are answered from parquet footers /
  range arithmetic with zero data blocks read when the plan shape allows.
- blocks are columnar dict-of-numpy (block.py), the layout `iter_batches`
  copies straight onto the device for host→device prefetch.
- `split()` hands disjoint block sets to SPMD train workers (the
  split-per-worker iterator of the reference's streaming_split).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data.block import (
    Block,
    block_concat,
    block_filter_expr,
    block_num_rows,
    block_rows,
    block_select_columns,
    block_slice,
    normalize_batch,
    rows_to_block,
)

# one fused op: (kind, payload) — see _logical/operators.py FusedOp
_Op = Tuple[str, Any]


def _apply_ops(block: Block, ops: List[_Op]) -> Block:
    for kind, fn in ops:
        if kind == "map_batches":
            block = fn(normalize_batch(block))
        elif kind == "map":
            block = rows_to_block([fn(r) for r in block_rows(block)])
        elif kind == "filter":
            block = rows_to_block([r for r in block_rows(block) if fn(r)])
        elif kind == "flat_map":
            out: List[Any] = []
            for r in block_rows(block):
                out.extend(fn(r))
            block = rows_to_block(out)
        elif kind == "project":
            block = block_select_columns(block, fn)
        elif kind == "filter_expr":
            block = block_filter_expr(block, fn)
        elif kind == "limit":
            # the per-block cap limit pushdown fuses into the chain; the
            # GLOBAL stream-order cut happens where blocks surface
            if block_num_rows(block) > fn:
                block = block_slice(block, 0, fn)
        else:  # pragma: no cover — plan construction guards kinds
            raise ValueError(f"unknown op {kind}")
    return block


def _run_chain(producer_or_block, ops: List[_Op]) -> Block:
    """The per-block fused task body: produce (or receive) the source block,
    then apply the whole op chain."""
    block = producer_or_block() if callable(producer_or_block) else producer_or_block
    from ray_tpu_torch._private.core_worker import ObjectRef

    if isinstance(block, ObjectRef):
        # closure-captured ref (union over materialized blocks): resolve
        # in-task — only top-level args resolve automatically
        import ray_tpu_torch

        block = ray_tpu_torch.get(block, timeout=600)
    return _apply_ops(block, ops)


class _CallableWrapper:
    """Adapts a plain function to the actor-pool UDF-class protocol."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, batch):
        return self._fn(batch)

    @staticmethod
    def of(fn):
        import functools

        return functools.partial(_CallableWrapper, fn)


class Dataset:
    """A lazy distributed collection of blocks, described by a logical
    plan. All transforms are lazy (they stack plan nodes); consumption
    optimizes + compiles the plan and triggers one fused remote task per
    block. All-to-all ops (sort/shuffle/groupby/join/zip) execute when
    called, through the same planner node executors.
    """

    def __init__(self, producers: Optional[List[Any]] = None, *,
                 _refs: Optional[List[Any]] = None,
                 _plan=None):
        from ray_tpu_torch.data._logical import operators as lops

        if _plan is not None:
            plan = _plan
        elif _refs is not None:
            plan = lops.InputBlocks(list(_refs))
        else:
            from ray_tpu_torch.data.datasource import SimpleDatasource

            plan = lops.Read(SimpleDatasource(list(producers or [])))
        self._plan = plan
        self._refs = list(_refs) if _refs is not None else None
        self._last_stats = None
        self._opt_cache = None  # (plan identity, optimized, fired)
        self._agg_refs: Dict[str, List[Any]] = {}

    # -- plan plumbing --------------------------------------------------

    @classmethod
    def _from_plan(cls, plan) -> "Dataset":
        return cls(_plan=plan)

    @classmethod
    def _from_datasource(cls, datasource) -> "Dataset":
        from ray_tpu_torch.data._logical import operators as lops

        return cls(_plan=lops.Read(datasource))

    @classmethod
    def _from_refs(cls, refs: List[Any]) -> "Dataset":
        return cls(_refs=list(refs))

    def _plan_for_child(self):
        """Derived datasets build on the materialized blocks once this one
        executed (repeat consumption of a shared prefix is free)."""
        from ray_tpu_torch.data._logical import operators as lops

        if self._refs is not None:
            return lops.InputBlocks(self._refs)
        return self._plan

    def _optimizer_enabled(self) -> bool:
        from ray_tpu_torch.data.context import DataContext

        return DataContext.get_current().optimizer_enabled

    def _optimized(self):
        """(optimized plan, fired-rule log) — cached per logical plan."""
        if not self._optimizer_enabled():
            return self._plan, []
        if self._opt_cache is None or self._opt_cache[0] is not self._plan:
            from ray_tpu_torch.data._logical.optimizer import optimize

            opt, fired = optimize(self._plan)
            self._opt_cache = (self._plan, opt, fired)
        return self._opt_cache[1], self._opt_cache[2]

    # -- transforms (lazy) ---------------------------------------------

    def map_batches(self, fn: Any, *, columns: Optional[List[str]] = None,
                    concurrency: Optional[int] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None) -> "Dataset":
        """Apply fn to whole blocks in columnar {col: ndarray} form.

        `columns=` declares the column subset the UDF needs — a Project
        node the optimizer folds into `read_parquet(columns=)` / `read_sql`
        column lists (projection pushdown), so dropped columns are never
        materialized.

        A CLASS (or any callable with `concurrency=`) becomes a stateful
        actor-pool stage: `concurrency` actors each construct the UDF once
        (fn_constructor_args) and stream blocks through it — the reference's
        ActorPoolMapOperator, for UDFs with expensive setup (model weights,
        tokenizers). `concurrency=(min, max)` enables queue-driven actor
        AUTOSCALING in the streaming executor (reference:
        actor_pool_map_operator.py + actor_autoscaler)."""
        from ray_tpu_torch.data._logical import operators as lops

        plan = self._plan_for_child()
        if columns is not None:
            plan = lops.Project(plan, list(columns))
        if concurrency is not None or isinstance(fn, type):
            udf = fn if isinstance(fn, type) else _CallableWrapper.of(fn)
            if isinstance(concurrency, tuple):
                conc: Any = (int(concurrency[0]), int(concurrency[1]))
            else:
                conc = int(concurrency or 1)
            return Dataset._from_plan(lops.ActorPoolMap(
                plan, udf, tuple(fn_constructor_args),
                dict(fn_constructor_kwargs or {}), conc))
        return Dataset._from_plan(lops.MapBatches(plan, fn))

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        from ray_tpu_torch.data._logical import operators as lops

        return Dataset._from_plan(lops.MapRows(self._plan_for_child(), fn))

    def filter(self, fn: Optional[Callable[[Any], bool]] = None, *,
               expr=None) -> "Dataset":
        """Keep rows where fn(row) is true — or where a STRUCTURED column
        predicate holds: `expr=("col", ">=", 5)` (or a list of such tuples,
        AND semantics; the pyarrow `filters=` shape). Only the structured
        form is visible to predicate pushdown: over `read_parquet` it
        reaches the reader's `filters=` and prunes row groups at the IO
        layer."""
        from ray_tpu_torch.data._logical import operators as lops

        if expr is not None:
            if fn is not None:
                raise ValueError("filter takes fn OR expr, not both")
            return Dataset._from_plan(lops.Filter(
                self._plan_for_child(),
                expr=lops.normalize_filter_expr(expr)))
        if fn is None:
            raise ValueError("filter needs a callable or expr=")
        return Dataset._from_plan(lops.Filter(self._plan_for_child(), fn=fn))

    def flat_map(self, fn: Callable[[Any], List[Any]]) -> "Dataset":
        from ray_tpu_torch.data._logical import operators as lops

        return Dataset._from_plan(lops.FlatMap(self._plan_for_child(), fn))

    def select_columns(self, columns: List[str]) -> "Dataset":
        """Project to a column subset (reference: Dataset.select_columns).
        Folds into column-capable datasources via projection pushdown."""
        from ray_tpu_torch.data._logical import operators as lops

        return Dataset._from_plan(
            lops.Project(self._plan_for_child(), list(columns)))

    def limit(self, n: int) -> "Dataset":
        """Truncate to the first `n` rows (reference: Dataset.limit + the
        logical optimizer's limit pushdown). The planner compiles this to
        (a) a per-block cap fused into the task chain, (b) a global
        stream-order cut wherever blocks surface, and (c) covering-prefix
        execution — `limit(k)` over B blocks submits only the producer
        prefix whose rows cover k. A row-count-changing op chained after
        limit() lands behind a stream-order fence, so it never observes
        rows beyond the global budget."""
        from ray_tpu_torch.data._logical import operators as lops

        if n < 0:
            raise ValueError("limit must be >= 0")
        return Dataset._from_plan(lops.Limit(self._plan_for_child(), n))

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets at the PLAN level: each branch's producers
        (with their pending chains baked into closures) join one producer
        list — no materialization, no driver row round-trip."""
        from ray_tpu_torch.data._logical import operators as lops

        return Dataset._from_plan(lops.Union(
            self._plan_for_child(),
            *[ds._plan_for_child() for ds in others]))

    def repartition(self, num_blocks: int) -> "Dataset":
        """Rebalance rows into `num_blocks` equal blocks (lazy plan node;
        executes on consumption). Each output task receives only the input
        blocks overlapping its row range — O(N) total movement, not
        all-blocks-to-every-task."""
        from ray_tpu_torch.data._logical import operators as lops

        return Dataset._from_plan(
            lops.Repartition(self._plan_for_child(), int(num_blocks)))

    # -- execution ------------------------------------------------------

    def materialize(self) -> "Dataset":
        """Execute the plan (optimize → compile → one fused remote task
        per block; actor stages route through their pools). Returns a
        Dataset backed by block ObjectRefs (repeat consumption is free)."""
        if self._refs is not None:
            return self
        refs = self._block_refs()
        return Dataset(_refs=refs)

    def _block_refs(self) -> List[Any]:
        # cache the materialization on THIS dataset too: repeated consumers
        # (sum then mean then std; schema after count) must not re-execute
        # the whole plan per call
        if self._refs is None:
            from ray_tpu_torch.data._logical import planner

            plan, _fired = self._optimized()
            refs, stats = planner.execute_to_refs(planner.compile_plan(plan))
            self._refs = refs
            self._last_stats = stats
        return self._refs

    def iter_blocks(self, *, window: Optional[int] = None) -> Iterator[Block]:
        """STREAMING consumption: pull blocks through the plan under the
        v2 streaming executor (per-stage dispatch, per-op byte budgets,
        actor autoscaling — see ray_tpu_torch.data._executor). Materialized
        datasets iterate their cached refs.

        Streaming deliberately does NOT cache results: repeat consumption
        re-executes the plan (and re-creates actor pools). Call
        materialize() first to pin block refs for repeated reads — the
        aggregate/sort/shuffle paths do so internally via _block_refs."""
        import ray_tpu_torch

        if self._refs is not None:
            for ref in self._refs:
                yield ray_tpu_torch.get(ref, timeout=600)
            return
        if window is None:
            from ray_tpu_torch.data.context import DataContext

            window = DataContext.get_current().streaming_block_window
        from ray_tpu_torch.data._logical import planner

        plan, _fired = self._optimized()
        segments = planner.compile_plan(plan)
        holder: dict = {}
        try:
            yield from planner.iter_plan(segments, window=window,
                                         holder=holder)
        finally:
            self._last_stats = holder.get("stats") or self._last_stats

    # -- consumption ----------------------------------------------------

    def num_blocks(self) -> int:
        if self._refs is not None:
            return len(self._refs)
        from ray_tpu_torch.data._logical import planner

        n = planner.resolve_num_blocks(self._plan)
        if n is not None:
            return n
        return len(self._block_refs())

    def count(self) -> int:
        """Row count. When the (optimized) plan supports it — parquet
        footers, range/from_items arithmetic, row-preserving chains — the
        answer comes from METADATA with zero data blocks read; the
        recorded stats show no tasks ran."""
        from ray_tpu_torch.data._logical import planner

        if self._refs is None and self._optimizer_enabled():
            plan, _fired = self._optimized()
            n = planner.resolve_count(plan)
            if n is not None:
                self._last_stats = planner.record_metadata_stats(
                    "", "count", f"{n} rows, zero blocks read")
                return n
        refs = self._block_refs()
        return sum(planner._row_counts(refs))

    def explain(self) -> str:
        """The planner's full story: the logical plan this dataset built,
        the optimizer rules that fired (fusion, limit/projection/predicate
        pushdown), and the compiled physical stages. One "tasks[...]" line
        = ONE fused remote task per block; a "limit[stream-order fence: n
        rows]" line marks a fence (ops below it only ever see rows within
        the global budget)."""
        from ray_tpu_torch.data._logical import operators as lops
        from ray_tpu_torch.data._logical import planner

        lines = ["Logical plan:"]
        lines += ["  " + s for s in lops.render_tree(self._plan)]
        if self._optimizer_enabled():
            plan, fired = self._optimized()
            lines.append("Rules fired:")
            lines += [f"  - {f}" for f in fired] or ["  (none)"]
        else:
            plan = self._plan
            lines.append("Rules fired:")
            lines.append("  (optimizer disabled)")
        lines.append("Physical plan:")
        lines += planner.describe_segments(
            planner.compile_plan(plan, allow_execute=False))
        return "\n".join(lines)

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for block in self.iter_blocks():
            for row in block_rows(block):
                out.append(row)
                if len(out) >= limit:
                    return out
        return out

    def take_all(self) -> List[Any]:
        return self.take(limit=2**62)

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_blocks():
            yield from block_rows(block)

    def iter_batches(
        self,
        batch_size: Optional[int] = 256,
        *,
        drop_last: bool = False,
        device_put: bool = False,
        device: Any = None,
        prefetch_blocks: int = 2,
    ) -> Iterator[Block]:
        """Iterate fixed-size columnar batches across block boundaries.

        device_put=True moves each numpy batch onto `device` (None: CUDA)
        before yielding. Each column is copied through pinned host memory
        with non_blocking=True on the current stream, so the host→device
        transfer overlaps the consumer's step (the reference's
        iter_torch_batches prefetch). Columns take the dtypes a 32-bit
        device array has: int64 → int32, uint64 → uint32, float64 →
        float32, complex128 → complex64; a column that is not numeric
        raises TypeError.

        Unmaterialized datasets STREAM: at most `prefetch_blocks` source
        blocks are in flight and consumed blocks free their shm copies
        before more are admitted, so datasets larger than the object store
        iterate in constant memory.
        """
        carry: Optional[Block] = None

        def to_out(b: Block) -> Block:
            if device_put and isinstance(b, dict):
                from ray_tpu_torch._private.device import resolve_device

                dev = resolve_device(device)
                return {k: _put_column(v, dev) for k, v in b.items()}
            return b

        for block in self.iter_blocks(
                window=None if prefetch_blocks is None
                else max(1, prefetch_blocks)):
            carry = block if carry is None else block_concat([carry, block])
            if batch_size is None:
                yield to_out(carry)
                carry = None
                continue
            while block_num_rows(carry) >= batch_size:
                yield to_out(block_slice(carry, 0, batch_size))
                carry = block_slice(carry, batch_size, block_num_rows(carry))
        if carry is not None and block_num_rows(carry) > 0 and not drop_last:
            yield to_out(carry)

    # -- reorganization -------------------------------------------------

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """Split into n datasets over disjoint blocks (per-train-worker
        shards; reference: Dataset.split / streaming_split). equal=True
        repartitions first so every shard has the same row count (±1), which
        SPMD training needs for lockstep batches."""
        if equal:
            refs = self.repartition(n)._block_refs()
            return [Dataset(_refs=[r]) for r in refs]
        refs = self._block_refs()
        shards: List[List[Any]] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            shards[i % n].append(ref)
        return [Dataset(_refs=s) for s in shards]

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Global random shuffle (materializes). Two-stage push shuffle as
        in the reference's shuffle ops — O(N) total movement; executed by
        the planner's RandomShuffle node."""
        from ray_tpu_torch.data._logical import operators as lops
        from ray_tpu_torch.data._logical import planner

        node = lops.RandomShuffle(lops.InputBlocks(self._block_refs()), seed)
        return Dataset._from_refs(planner.execute_node(node))

    def sort(self, key: str, *, descending: bool = False) -> "Dataset":
        """Distributed sort (materializes): sample key range →
        range-partition scatter → per-partition sort (reference: data sort
        ops; the classic TeraSort shape) — the planner's Sort node."""
        from ray_tpu_torch.data._logical import operators as lops
        from ray_tpu_torch.data._logical import planner

        node = lops.Sort(lops.InputBlocks(self._block_refs()), key,
                         descending)
        return Dataset._from_refs(planner.execute_node(node))

    def groupby(self, key: str) -> "GroupedData":
        """Group rows by a key column (reference: Dataset.groupby +
        hash-shuffle aggregate ops)."""
        return GroupedData(self, key)

    # -- multi-dataset ops (reference: Dataset.union/zip/join) ----------

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two datasets with equal row counts
        (reference: Dataset.zip): the other dataset is range-repartitioned
        to this one's block boundaries, then each aligned pair merges
        columns in one task (duplicate names get a _1 suffix). Validates
        row counts up front (materializes both sides)."""
        from ray_tpu_torch.data._logical import operators as lops
        from ray_tpu_torch.data._logical import planner

        node = lops.Zip(lops.InputBlocks(self._block_refs()),
                        lops.InputBlocks(other._block_refs()))
        return Dataset._from_refs(planner.execute_node(node))

    def join(self, other: "Dataset", on: str, *, how: str = "inner",
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed hash join on column `on` (reference: the data join
        operator / hash_shuffle) — the planner's Join node: both sides
        scatter rows by hash(key) into k partitions, then one task per
        partition builds-and-probes — O(N) movement, k-way parallel."""
        if how not in ("inner", "left"):
            raise ValueError(f"unsupported join type {how!r}")
        from ray_tpu_torch.data._logical import operators as lops
        from ray_tpu_torch.data._logical import planner

        node = lops.Join(lops.InputBlocks(self._block_refs()),
                         lops.InputBlocks(other._block_refs()),
                         on, how, num_partitions)
        return Dataset._from_refs(planner.execute_node(node))

    # -- global aggregates (reference: Dataset.sum/min/max/mean/std) ----

    def _agg_input_refs(self, col: Optional[str]) -> List[Any]:
        """Block refs feeding a single-column aggregate. On an
        unmaterialized plan over a column-capable source, a Project([col])
        is pushed through the optimizer first — the read materializes ONLY
        that column (projection pushdown for aggregates)."""
        if self._refs is not None:
            return self._refs
        if col is not None and self._optimizer_enabled():
            if col in self._agg_refs:
                return self._agg_refs[col]
            from ray_tpu_torch.data._logical import operators as lops
            from ray_tpu_torch.data._logical.optimizer import optimize
            from ray_tpu_torch.data._logical import planner

            opt, _fired = optimize(lops.Project(self._plan, [col]))
            if planner.projection_folded(opt):
                refs, stats = planner.execute_to_refs(
                    planner.compile_plan(opt))
                self._agg_refs[col] = refs
                self._last_stats = stats
                return refs
        return self._block_refs()

    def _column_stats(self, col: str):
        import ray_tpu_torch
        from ray_tpu_torch.remote_function import RemoteFunction

        def _stats(block):
            v = np.asarray(block[col]) if isinstance(block, dict) else (
                np.asarray([r[col] for r in block_rows(block)])
            )
            if v.size == 0:
                # None (not 0.0) so an empty block can't masquerade as a
                # numeric contribution on a non-numeric column
                return (0, None, None, None, None)
            # String keys are legal sort()/min()/max() inputs; only numeric
            # dtypes have a sum / sum-of-squares (advisor r2).
            if np.issubdtype(v.dtype, np.number) or v.dtype == np.bool_:
                total = float(v.sum())
                sq = float((v.astype(np.float64) ** 2).sum())
                mn, mx = v.min().item(), v.max().item()
            else:
                # np.min has no ufunc loop for str/object dtypes
                total = sq = None
                vals = v.tolist()
                mn, mx = min(vals), max(vals)
            return (int(v.size), total, sq, mn, mx)

        parts = ray_tpu_torch.get(
            [RemoteFunction(_stats).remote(r)
             for r in self._agg_input_refs(col)],
            timeout=600,
        )
        n = sum(p[0] for p in parts)
        sums = [p[1] for p in parts if p[1] is not None]
        sqs = [p[2] for p in parts if p[2] is not None]
        total = sum(sums) if sums else None
        sq = sum(sqs) if sqs else None
        mins = [p[3] for p in parts if p[3] is not None]
        maxs = [p[4] for p in parts if p[4] is not None]
        return n, total, sq, (min(mins) if mins else None), (max(maxs) if maxs else None)

    def sum(self, col: str):
        return self._column_stats(col)[1]

    def mean(self, col: str):
        n, total, *_ = self._column_stats(col)
        return total / n if (n and total is not None) else None

    def min(self, col: str):
        return self._column_stats(col)[3]

    def max(self, col: str):
        return self._column_stats(col)[4]

    def std(self, col: str, ddof: int = 1):
        n, total, sq, _, _ = self._column_stats(col)
        if n <= ddof or total is None or sq is None:
            return None
        mean = total / n
        return float(np.sqrt(max(0.0, (sq - n * mean * mean) / (n - ddof))))

    # -- introspection --------------------------------------------------

    def stats(self) -> str:
        """Per-op execution table of the most recent consumption
        (reference: python/ray/data/stats.py — blocks, bytes, task times,
        peak concurrency/queue, backpressure time per operator; the
        materialize path reports per-segment rows, metadata-answered
        queries report a zero-task metadata row)."""
        st = self._last_stats
        if st is None:
            return ("(no stats yet: stats cover plan execution — "
                    "consume the dataset first)")
        return str(st)

    def schema(self) -> Optional[Dict[str, str]]:
        """{column: dtype}. Answered from datasource METADATA (parquet
        footer schema, range arithmetic) when the plan shape allows —
        zero data blocks read."""
        import ray_tpu_torch

        from ray_tpu_torch.data._logical import planner

        if self._refs is None and self._optimizer_enabled():
            plan, _fired = self._optimized()
            s = planner.resolve_schema(plan)
            if s is not None:
                self._last_stats = planner.record_metadata_stats(
                    "", "schema", "zero blocks read")
                return s
        refs = self._block_refs()
        if not refs:
            return None
        block = ray_tpu_torch.get(refs[0], timeout=600)
        if isinstance(block, dict):
            return {k: str(v.dtype) for k, v in block.items()}
        return None

    def __repr__(self):
        from ray_tpu_torch.data._logical import planner

        nb = (len(self._refs) if self._refs is not None
              else planner.resolve_num_blocks(self._plan))
        return (f"Dataset(blocks={'?' if nb is None else nb}, "
                f"plan={self._plan.label()})")


class GroupedData:
    """Hash-partitioned group-by + aggregates (reference: data groupby with
    hash_shuffle aggregate operators), executed by the planner's GroupByAgg
    node. Keys scatter to k partitions by hash; each partition aggregates
    its groups independently."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _aggregate(self, agg: str, col: Optional[str]) -> Dataset:
        from ray_tpu_torch.data._logical import operators as lops
        from ray_tpu_torch.data._logical import planner

        if agg not in planner.GROUP_AGGS:
            raise ValueError(f"unknown aggregate {agg!r}")
        refs = self._ds._block_refs()
        if not refs:
            return Dataset(_refs=[])
        node = lops.GroupByAgg(lops.InputBlocks(refs), self._key, agg, col)
        return Dataset._from_refs(planner.execute_node(node))

    def count(self) -> Dataset:
        return self._aggregate("count", None)

    def sum(self, col: str) -> Dataset:
        return self._aggregate("sum", col)

    def mean(self, col: str) -> Dataset:
        return self._aggregate("mean", col)

    def min(self, col: str) -> Dataset:
        return self._aggregate("min", col)

    def max(self, col: str) -> Dataset:
        return self._aggregate("max", col)


# A device array holds no 64-bit type (x64 off in the reference's arrays).
_DEVICE_PUT_CASTS = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}


def _put_column(col: Any, dev: Any) -> Any:
    """One column as a tensor on `dev`: cast to its 32-bit dtype while it
    is copied into (pinned, for CUDA) host memory, then moved without
    blocking the host."""
    import torch

    a = np.asarray(col)
    if a.dtype.name == "bfloat16":
        a, view = a.view(np.int16), torch.bfloat16
        target = a.dtype
    elif a.dtype.kind in "biufc":
        target, view = _DEVICE_PUT_CASTS.get(a.dtype, a.dtype), None
    else:
        raise TypeError(
            f"Dtype {a.dtype} is not a valid device array type. Only arrays "
            "of numeric types are supported.")
    host = torch.empty(a.shape,
                       dtype=torch.from_numpy(np.empty(0, target)).dtype,
                       pin_memory=dev.type == "cuda")
    host.numpy()[...] = a
    if view is not None:
        host = host.view(view)
    return host.to(dev, non_blocking=True) if dev.type == "cuda" else host

