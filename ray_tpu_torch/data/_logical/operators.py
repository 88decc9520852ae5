"""Logical operators for the ray_tpu_torch.data query planner.

Reference surface: python/ray/data/_internal/logical/operators/ (Read,
AbstractMap, Limit, Project, AllToAll ops, Union/Zip/Join) — the node
vocabulary the rule-based optimizer rewrites and the physical planner
compiles (planner.py here; `_internal/planner/planner.py:230` there).

A Dataset holds exactly one of these trees and never mutates it: every
transform stacks a node. Nodes are cheap immutable-ish records; rules
rebuild subtrees via `with_inputs` (shallow copy, so the execution caches
on materializing nodes are shared between the pre- and post-rewrite
plans).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional, Sequence, Tuple

# one fused op: (kind, payload). kind in {"map", "map_batches", "filter",
# "flat_map", "project", "filter_expr", "limit"}; payload is the UDF — or
# the column list / predicate list / row cap for the data-driven kinds.
FusedOp = Tuple[str, Any]

_EXPR_OPS = ("==", "=", "!=", "<", "<=", ">", ">=", "in", "not in")


def normalize_filter_expr(expr) -> List[tuple]:
    """Validate a structured predicate: one (col, op, value) tuple or a
    list of them (AND semantics — the pyarrow `filters=` DNF conjunction
    shape, which is exactly what predicate pushdown hands the parquet
    reader)."""
    exprs = [expr] if isinstance(expr, tuple) else list(expr)
    out = []
    for e in exprs:
        if (not isinstance(e, tuple) or len(e) != 3
                or not isinstance(e[0], str) or e[1] not in _EXPR_OPS):
            raise ValueError(
                f"filter expr must be (column, op, value) with op in "
                f"{_EXPR_OPS}, got {e!r}")
        out.append((e[0], "==" if e[1] == "=" else e[1], e[2]))
    return out


def expr_columns(exprs: List[tuple]) -> List[str]:
    return sorted({c for c, _op, _v in exprs})


class LogicalOp:
    """Base logical node. `inputs` are upstream nodes (dataflow order:
    inputs produce the rows this node consumes)."""

    name = "Op"

    def __init__(self, *inputs: "LogicalOp"):
        self.inputs: List[LogicalOp] = list(inputs)

    @property
    def input(self) -> "LogicalOp":
        return self.inputs[0]

    def with_inputs(self, inputs: Sequence["LogicalOp"]) -> "LogicalOp":
        node = copy.copy(self)
        node.inputs = list(inputs)
        return node

    def label(self) -> str:
        return self.name

    def __repr__(self):
        return self.label()


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------


class Read(LogicalOp):
    """Leaf over a Datasource (datasource.py): the pushdown surface.
    Projection/predicate rules rewrite `datasource` in place of wrapping
    nodes; metadata shortcuts ask it for count/schema from footers."""

    name = "Read"

    def __init__(self, datasource):
        super().__init__()
        self.datasource = datasource

    def label(self) -> str:
        return f"Read[{self.datasource.describe()}]"


class InputBlocks(LogicalOp):
    """Leaf of already-computed block ObjectRefs (a materialized dataset)."""

    name = "InputBlocks"

    def __init__(self, refs: List[Any]):
        super().__init__()
        self.refs = list(refs)

    def label(self) -> str:
        return f"InputBlocks[{len(self.refs)} blocks]"


# ---------------------------------------------------------------------------
# row transforms (fusable)
# ---------------------------------------------------------------------------


def _fn_name(fn) -> str:
    return getattr(fn, "__name__", None) or type(fn).__name__


class AbstractMap(LogicalOp):
    """A per-block transform that fuses into one task chain.
    `row_preserving` marks 1:1 ops (map/project): the only kinds allowed
    to ride a fused chain past a limit — anything that can change row
    counts must run behind the stream-order fence (ADVICE r5 #1)."""

    row_preserving = False

    def fused_ops(self) -> List[FusedOp]:
        raise NotImplementedError


class MapBatches(AbstractMap):
    name = "MapBatches"

    def __init__(self, input_op: LogicalOp, fn: Callable):
        super().__init__(input_op)
        self.fn = fn

    def fused_ops(self):
        return [("map_batches", self.fn)]

    def label(self):
        return f"MapBatches[{_fn_name(self.fn)}]"


class MapRows(AbstractMap):
    name = "Map"
    row_preserving = True

    def __init__(self, input_op: LogicalOp, fn: Callable):
        super().__init__(input_op)
        self.fn = fn

    def fused_ops(self):
        return [("map", self.fn)]

    def label(self):
        return f"Map[{_fn_name(self.fn)}]"


class Filter(AbstractMap):
    """Row filter: a Python callable OR a structured column predicate
    (`expr`). Only the structured form is visible to predicate pushdown —
    a lambda is opaque."""

    name = "Filter"

    def __init__(self, input_op: LogicalOp, fn: Optional[Callable] = None,
                 expr: Optional[List[tuple]] = None):
        super().__init__(input_op)
        if (fn is None) == (expr is None):
            raise ValueError("Filter takes exactly one of fn / expr")
        self.fn = fn
        self.expr = expr

    def fused_ops(self):
        if self.expr is not None:
            return [("filter_expr", self.expr)]
        return [("filter", self.fn)]

    def label(self):
        if self.expr is not None:
            return f"Filter[{self.expr}]"
        return f"Filter[{_fn_name(self.fn)}]"


class FlatMap(AbstractMap):
    name = "FlatMap"

    def __init__(self, input_op: LogicalOp, fn: Callable):
        super().__init__(input_op)
        self.fn = fn

    def fused_ops(self):
        return [("flat_map", self.fn)]

    def label(self):
        return f"FlatMap[{_fn_name(self.fn)}]"


class Project(AbstractMap):
    """Column selection. Projection pushdown folds this into
    `read_parquet(columns=)` / `read_sql` column lists."""

    name = "Project"
    row_preserving = True

    def __init__(self, input_op: LogicalOp, columns: List[str]):
        super().__init__(input_op)
        self.columns = list(columns)

    def fused_ops(self):
        return [("project", list(self.columns))]

    def label(self):
        return f"Project[{', '.join(self.columns)}]"


class FusedMap(AbstractMap):
    """The fusion rule's output: an adjacent run of map-like nodes
    collapsed into one op chain = ONE remote task per block."""

    name = "FusedMap"

    def __init__(self, input_op: LogicalOp, ops: List[FusedOp],
                 labels: List[str]):
        super().__init__(input_op)
        self.ops = list(ops)
        self.labels = list(labels)

    @property
    def row_preserving(self):
        return all(k in ("map", "project", "limit") for k, _ in self.ops)

    def fused_ops(self):
        return list(self.ops)

    def label(self):
        return f"FusedMap[{' -> '.join(self.labels)}]"


class ActorPoolMap(LogicalOp):
    """Stateful map_batches through an (auto-scaling) actor pool
    (reference: actor_pool_map_operator.py). Never fuses with task ops."""

    name = "ActorPoolMap"

    def __init__(self, input_op: LogicalOp, udf_cls, fn_args: tuple,
                 fn_kwargs: dict, concurrency):
        super().__init__(input_op)
        self.udf_cls = udf_cls
        self.fn_args = tuple(fn_args)
        self.fn_kwargs = dict(fn_kwargs)
        self.concurrency = concurrency

    def stage(self):
        return ("actors", self.udf_cls, self.fn_args, self.fn_kwargs,
                self.concurrency)

    def label(self):
        return (f"ActorPoolMap[{_fn_name(self.udf_cls)}, "
                f"concurrency={self.concurrency}]")


# ---------------------------------------------------------------------------
# limit / multi-input / reorganization
# ---------------------------------------------------------------------------


class Limit(LogicalOp):
    """First-n-rows in stream order. The planner compiles this into (a) a
    per-block cap fused into the task chain, (b) a global stream-order cut
    wherever blocks surface, and (c) covering-prefix execution — only the
    producer prefix whose rows cover n is ever submitted."""

    name = "Limit"

    def __init__(self, input_op: LogicalOp, n: int):
        super().__init__(input_op)
        self.n = int(n)

    def label(self):
        return f"Limit[{self.n}]"


class Union(LogicalOp):
    """Plan-level concatenation: each branch's producers (with their own
    pending chains baked into closures) join one producer list — no
    driver row round-trip, no forced materialization."""

    name = "Union"

    def __init__(self, *branches: LogicalOp):
        super().__init__(*branches)

    def label(self):
        return f"Union[{len(self.inputs)} branches]"


class Materializing(LogicalOp):
    """Base for all-to-all ops (reference: logical AbstractAllToAll): the
    physical planner executes these to block refs (cached on the node, so
    every dataset sharing the subtree reuses the shuffle)."""

    def __init__(self, *inputs: LogicalOp):
        super().__init__(*inputs)
        # shared mutable cell so with_inputs copies share the execution
        self._cache: dict = {}


class Repartition(Materializing):
    name = "Repartition"

    def __init__(self, input_op: LogicalOp, num_blocks: int):
        super().__init__(input_op)
        self.num_blocks = int(num_blocks)

    def label(self):
        return f"Repartition[{self.num_blocks}]"


class Sort(Materializing):
    name = "Sort"

    def __init__(self, input_op: LogicalOp, key: str, descending: bool):
        super().__init__(input_op)
        self.key = key
        self.descending = descending

    def label(self):
        return f"Sort[{self.key}{', desc' if self.descending else ''}]"


class RandomShuffle(Materializing):
    name = "RandomShuffle"

    def __init__(self, input_op: LogicalOp, seed):
        super().__init__(input_op)
        self.seed = seed

    def label(self):
        return f"RandomShuffle[seed={self.seed}]"


class GroupByAgg(Materializing):
    name = "GroupByAgg"

    def __init__(self, input_op: LogicalOp, key: str, agg: str,
                 col: Optional[str]):
        super().__init__(input_op)
        self.key = key
        self.agg = agg
        self.col = col

    def label(self):
        return f"GroupByAgg[{self.key}: {self.agg}({self.col or ''})]"


class Join(Materializing):
    name = "Join"

    def __init__(self, left: LogicalOp, right: LogicalOp, on: str,
                 how: str, num_partitions: Optional[int]):
        super().__init__(left, right)
        self.on = on
        self.how = how
        self.num_partitions = num_partitions

    def label(self):
        return f"Join[{self.how} on {self.on}]"


class Zip(Materializing):
    name = "Zip"

    def __init__(self, left: LogicalOp, right: LogicalOp):
        super().__init__(left, right)

    def label(self):
        return "Zip"


def walk(node: LogicalOp):
    """Pre-order traversal of a plan tree. Iterative: plans grow one node
    per transform call, so chains can be deeper than the Python recursion
    limit."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(reversed(n.inputs))


def render_tree(node: LogicalOp, indent: int = 0) -> List[str]:
    lines: List[str] = []
    stack = [(node, indent)]
    while stack:
        n, d = stack.pop()
        lines.append("  " * d + n.label())
        stack.extend((c, d + 1) for c in reversed(n.inputs))
    return lines
