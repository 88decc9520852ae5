"""ray_tpu_torch.data._logical — the query-planning subsystem.

Reference surface: python/ray/data/_internal/logical/ (operators + rules +
optimizers) and _internal/planner/planner.py. Three layers:

  operators.py  — the logical node vocabulary Datasets build lazily
  rules.py + optimizer.py — rule-based rewrites applied to fixpoint
                  (fusion, limit/projection/predicate pushdown), every
                  firing recorded for explain()
  planner.py    — compiles the optimized plan to streamable Segments
                  (StreamingExecutorV2 / _Pipeline), executes all-to-all
                  nodes, and answers count/schema/num_blocks from
                  metadata with zero data blocks read
"""

from ray_tpu_torch.data._logical import operators, optimizer, planner, rules

__all__ = ["operators", "optimizer", "planner", "rules"]
