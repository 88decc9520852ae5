"""Scaling and failure policies for the Train controller (the port's copy
of ``ray_tpu/train/_policies.py``).

Reference: python/ray/train/v2/_internal/execution/scaling_policy/{fixed,
elastic}.py and failure_handling/ — the controller consults the scaling
policy for a target worker-group size and the failure policy for whether a
failure is retryable.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

from ray_tpu_torch._private import protocol as pb


@dataclass
class ScalingDecision:
    num_workers: int
    reason: str = ""


def usable_cluster_resources(
    nodes: List[dict],
    death_fresh_window_s: float = 120.0,
    now: Optional[float] = None,
) -> Dict[str, float]:
    """Capacity a worker group can actually be (re)placed on.

    A raw `cluster_resources()` sum over-counts during a planned removal:
    DRAINING nodes still appear in the node table (and a node that just
    received a drain notice may briefly still read ALIVE), so a post-drain
    re-create would target a width the shrunken cluster can't hold and
    immediately resize again. Subtract every node that is DRAINING, is
    carrying a drain reason, or has a fresh expected-death record before
    computing the fit."""
    now = time.time() if now is None else now
    total: Dict[str, float] = {}
    for n in nodes:
        if n.get("state") != "ALIVE":
            continue  # DEAD and DRAINING nodes host nothing new
        if pb.is_sim_node(n.get("labels")):
            continue  # scale-harness nodes can't host real workers
        if n.get("drain_reason"):
            continue  # notice landed, state transition racing
        death = n.get("death")
        if (death and death.get("expected")
                and now - death.get("ts", 0.0) < death_fresh_window_s):
            continue  # going away: a record beat the state field
        for k, v in (n.get("resources") or {}).items():
            total[k] = total.get(k, 0.0) + v
    return total


class ScalingPolicy:
    def target_size(self, cluster_cpus, resources_per_worker) -> ScalingDecision:
        raise NotImplementedError


class FixedScalingPolicy(ScalingPolicy):
    def __init__(self, num_workers: int):
        self.num_workers = num_workers

    def target_size(self, cluster_cpus, resources_per_worker):
        return ScalingDecision(self.num_workers, "fixed")


class ElasticScalingPolicy(ScalingPolicy):
    """Size the group to what the cluster can currently hold, within
    [min_workers, max_workers] (reference: scaling_policy/elastic.py).

    `cluster_resources` may be a full {resource: amount} dict (preferred:
    the fit respects every requested resource shape, e.g. custom "spot" or
    "GPU" markers, not just CPU) or a bare CPU count for compatibility.
    Feed it `usable_cluster_resources(...)` — sizing against a raw
    cluster sum counts DRAINING nodes and targets a width the cluster
    can't actually hold."""

    def __init__(self, min_workers: int, max_workers: int):
        assert 1 <= min_workers <= max_workers
        self.min_workers = min_workers
        self.max_workers = max_workers

    def target_size(self, cluster_resources: Union[float, Dict[str, float]],
                    resources_per_worker):
        if not isinstance(cluster_resources, dict):
            cluster_resources = {"CPU": float(cluster_resources)}
        per = {k: float(v) for k, v in (resources_per_worker or {}).items()
               if float(v) > 0}
        if not per:
            per = {"CPU": 1.0}
        fit = min(
            int(cluster_resources.get(k, 0.0) // v) for k, v in per.items()
        )
        n = max(self.min_workers, min(self.max_workers, fit))
        return ScalingDecision(n, f"elastic fit={fit}")


@dataclass
class FailurePolicy:
    """Retry budget for worker-group failures (reference: FailureConfig)."""

    max_failures: int = 0  # -1 = unlimited

    def decide(self, failure_count: int) -> bool:
        """True = retry (recreate the group), False = raise."""
        if self.max_failures == -1:
            return True
        return failure_count <= self.max_failures
