"""Rewrite rules for the logical optimizer.

Reference surface: python/ray/data/_internal/logical/rules/ (operator
fusion, limit pushdown, projection pushdown / column pruning) applied by
`logical/optimizers.py` to fixpoint — the Volcano-style rule pass Graefe's
optimizer generator popularized. Each rule is a pure plan→plan rewrite; the
optimizer records every firing so `Dataset.explain()` can print exactly
which rules shaped the physical plan.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ray_tpu_torch.data._logical import operators as ops


def _transform_up(node: ops.LogicalOp,
                  fn: Callable[[ops.LogicalOp], Optional[ops.LogicalOp]],
                  ) -> ops.LogicalOp:
    """Bottom-up rewrite: children first, then `fn` on the (possibly
    rebuilt) node. fn returns a replacement node or None (no match).
    Iterative post-order (explicit stack): plans grow one node per
    transform call, so chains can be deeper than the recursion limit."""
    done: dict = {}  # id(original node) -> rewritten node
    stack = [(node, False)]
    while stack:
        n, children_done = stack.pop()
        if not children_done:
            stack.append((n, True))
            stack.extend((c, False) for c in n.inputs)
            continue
        new_inputs = [done[id(c)] for c in n.inputs]
        rebuilt = n
        if any(a is not b for a, b in zip(new_inputs, n.inputs)):
            rebuilt = n.with_inputs(new_inputs)
        out = fn(rebuilt)
        done[id(n)] = rebuilt if out is None else out
    return done[id(node)]


class Rule:
    """One rewrite. apply() returns (new_root, fired) where fired is a
    human-readable description per match (empty = rule did not fire)."""

    name = "Rule"

    def apply(self, root: ops.LogicalOp
              ) -> Tuple[ops.LogicalOp, List[str]]:
        raise NotImplementedError


class LimitFoldRule(Rule):
    """limit(a) ∘ limit(b) → limit(min(a, b)) — two cuts of one stream."""

    name = "LimitFold"

    def apply(self, root):
        fired: List[str] = []

        def fn(node):
            if isinstance(node, ops.Limit) and isinstance(
                    node.input, ops.Limit):
                inner = node.input
                n = min(node.n, inner.n)
                fired.append(
                    f"{self.name}: limit({inner.n})+limit({node.n}) -> "
                    f"limit({n})")
                return ops.Limit(inner.input, n)
            return None

        return _transform_up(root, fn), fired


class LimitPushdownRule(Rule):
    """Push limit below row-preserving ops (map/project) toward the
    source, in stream order: `map(f).limit(n)` ≡ `limit(n).map(f)` for 1:1
    f, and the closer the limit sits to the read, the shorter the covering
    prefix the planner executes (reference: rules/limit_pushdown.py)."""

    name = "LimitPushdown"

    def apply(self, root):
        fired: List[str] = []

        def fn(node):
            if not (isinstance(node, ops.Limit) and isinstance(
                    node.input, ops.AbstractMap)
                    and node.input.row_preserving):
                return None
            # dataflow: ... -> map -> limit  ==>  ... -> limit -> map.
            # Sink below the WHOLE run of row-preserving ops in one firing:
            # one level per optimizer pass would strand the limit mid-chain
            # once the chain is deeper than the fixpoint pass budget
            run = []
            cur = node.input
            while isinstance(cur, ops.AbstractMap) and cur.row_preserving:
                run.append(cur)
                cur = cur.input
            fired.append(
                f"{self.name}: limit({node.n}) below "
                f"{' + '.join(m.label() for m in run)}")
            new = ops.Limit(cur, node.n)
            for m in reversed(run):
                new = m.with_inputs([new])
            return new

        return _transform_up(root, fn), fired


def _fold_through_limits(node, fold_read):
    """Descend through Limit nodes only (projection commutes with a row
    cut) looking for a foldable Read; returns a rebuilt subtree or None."""
    if isinstance(node, ops.Read):
        return fold_read(node)
    if isinstance(node, ops.Limit):
        inner = _fold_through_limits(node.input, fold_read)
        if inner is not None:
            return ops.Limit(inner, node.n)
    return None


class ProjectionPushdownRule(Rule):
    """Fold Project into a column-capable datasource: read_parquet grows
    `columns=`, read_sql rewrites its column list — the reader then never
    materializes dropped columns (reference: rules/projection_pushdown)."""

    name = "ProjectionPushdown"

    def apply(self, root):
        fired: List[str] = []

        def fn(node):
            if not isinstance(node, ops.Project):
                return None
            if isinstance(node.input, ops.Project):
                inner = node.input
                if not set(node.columns) <= set(inner.columns):
                    # outer names a column the inner projection dropped —
                    # collapsing would resurrect it; leave the plan alone
                    # so execution raises exactly like the unoptimized path
                    return None
                fired.append(
                    f"{self.name}: project∘project -> "
                    f"project({', '.join(node.columns)})")
                return ops.Project(inner.input, node.columns)

            def fold_read(read):
                ds = read.datasource
                if getattr(ds, "supports_column_pushdown", False) and \
                        ds.columns is None:
                    try:
                        pushed = ds.with_columns(node.columns)
                    except ValueError:
                        # datasource can't express these names (e.g. SQL
                        # rejects non-plain identifiers) — leave Project
                        # as a block op instead of failing the plan
                        return None
                    fired.append(
                        f"{self.name}: columns={node.columns} into "
                        f"{ds.describe()}")
                    return ops.Read(pushed)
                return None

            return _fold_through_limits(node.input, fold_read)

        return _transform_up(root, fn), fired


class PredicatePushdownRule(Rule):
    """Fold a structured column predicate (`filter(expr=...)`) directly
    over a Read into the datasource — the parquet reader gets pyarrow
    `filters=` and skips non-matching row groups at the IO layer."""

    name = "PredicatePushdown"

    def apply(self, root):
        fired: List[str] = []

        def fn(node):
            if not (isinstance(node, ops.Filter) and node.expr is not None
                    and isinstance(node.input, ops.Read)):
                return None
            ds = node.input.datasource
            if not getattr(ds, "supports_predicate_pushdown", False):
                return None
            if ds.columns is not None and not \
                    set(ops.expr_columns(node.expr)) <= set(ds.columns):
                # predicate names a column the pushed-down projection
                # dropped — pyarrow would filter on the full file schema
                # and silently succeed where the unoptimized chain errors
                return None
            fired.append(f"{self.name}: {node.expr} into {ds.describe()}")
            return ops.Read(ds.with_filters(node.expr))

        return _transform_up(root, fn), fired


class OperatorFusionRule(Rule):
    """Fuse adjacent map-like nodes into one FusedMap = ONE remote task
    per block (subsumes the old Dataset._chain hand fusion; reference:
    rules/operator_fusion.py). Runs after the pushdown rules so fusion
    never hides a Project/Filter from the datasource fold."""

    name = "OperatorFusion"

    def apply(self, root):
        fired: List[str] = []

        def fn(node):
            if not (isinstance(node, ops.AbstractMap)
                    and isinstance(node.input, ops.AbstractMap)):
                return None
            inner, outer = node.input, node
            in_labels = (inner.labels if isinstance(inner, ops.FusedMap)
                         else [inner.label()])
            out_labels = (outer.labels if isinstance(outer, ops.FusedMap)
                          else [outer.label()])
            fired.append(
                f"{self.name}: {' + '.join(in_labels + out_labels)}")
            return ops.FusedMap(
                inner.input, inner.fused_ops() + outer.fused_ops(),
                in_labels + out_labels)

        return _transform_up(root, fn), fired


# the canonical pass order: semantic folds and pushdowns first (they need
# raw node adjacency), fusion last (it erases adjacency into chains)
REWRITE_RULES = [LimitFoldRule, LimitPushdownRule, ProjectionPushdownRule,
                 PredicatePushdownRule]
FUSION_RULES = [OperatorFusionRule]
