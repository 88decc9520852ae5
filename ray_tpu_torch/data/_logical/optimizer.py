"""Fixpoint driver for the logical rules.

Reference: python/ray/data/_internal/logical/optimizers.py
(LogicalOptimizer.optimize — apply each rule until the plan stops
changing). Every firing is recorded (and counted on the rt_* metrics
plane) so `explain()` can show which rules shaped the plan.
"""

from __future__ import annotations

from typing import List, Tuple

from ray_tpu_torch.data._logical import operators as ops
from ray_tpu_torch.data._logical import rules as rules_mod

_MAX_PASSES = 20

def _count_rule(rule_name: str, n: int) -> None:
    try:
        from ray_tpu_torch.util.metrics import get_or_create_counter

        get_or_create_counter(
            "rt_data_rules_fired_total",
            "Logical-optimizer rule firings",
            tag_keys=("rule",)).inc(n, tags={"rule": rule_name})
    except Exception:  # noqa: BLE001 — metrics must never fail planning
        pass


def _fixpoint(root: ops.LogicalOp, rule_classes,
              fired: List[str]) -> ops.LogicalOp:
    for _ in range(_MAX_PASSES):
        changed = False
        for cls in rule_classes:
            root, hits = cls().apply(root)
            if hits:
                changed = True
                fired.extend(hits)
                _count_rule(cls.name, len(hits))
        if not changed:
            break
    return root


def optimize(root: ops.LogicalOp) -> Tuple[ops.LogicalOp, List[str]]:
    """Run rewrite rules to fixpoint, then fusion to fixpoint. Returns
    (optimized_root, fired) — fired is the ordered rule-firing log."""
    fired: List[str] = []
    root = _fixpoint(root, rules_mod.REWRITE_RULES, fired)
    root = _fixpoint(root, rules_mod.FUSION_RULES, fired)
    return root, fired
