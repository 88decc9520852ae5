"""Serve replica autoscaling plane.

Reference: python/ray/serve/_private/autoscaling_state.py
(AutoscalingStateManager) + autoscaling_policy.py's request-based policy.
The controller's reconcile loop feeds each deployment's freshly probed
replica stats into a per-deployment :class:`AutoscalingPolicy`; the policy
turns load signals into a target replica count with scale-up urgency and a
scale-down cooldown, and the pure placement helpers below decide how many
of the pending replicas actually FIT the cluster right now — the rest are
published through the ``report_demand`` plane so the node autoscaler
launches capacity for them (spike -> replicas -> nodes in one pass).

Everything here is pure/synchronous and unit-testable without a cluster;
the controller owns all RPC.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.protocol import ResourceSet

# stats keys consulted per signal (replica stats() for the queue signal;
# LLM deployments additionally surface engine stats through their
# callable's stats passthrough when they want latency/throughput scaling)
_QUEUE_KEYS = ("ongoing", "peak_ongoing", "queued", "peak_queued")


def replica_load(st: dict) -> float:
    """One replica's demand reading: in-flight plus queued, peak-of-window.

    The replica's ``peak_*`` counters are reset-on-poll high-water marks, so
    a burst that arrived and queued entirely between two 1s reconcile ticks
    still registers instead of aliasing to the instantaneous snapshot.
    """
    ongoing = max(st.get("ongoing", 0), st.get("peak_ongoing", 0))
    queued = max(st.get("queued", 0), st.get("peak_queued", 0))
    return float(ongoing) + float(queued)


class AutoscalingPolicy:
    """Per-deployment replica-count policy: load signals in, target out.

    Scale-up is urgent (after an optional ``upscale_delay_s`` the raw
    demand is adopted wholesale), scale-down is conservative: demand must
    stay below the current target for ``downscale_delay_s`` straight, and
    the new target is the PEAK demand observed inside that window — a
    sawtooth load holds its high-water fleet instead of thrashing replica
    churn (hysteresis, reference: autoscaling_policy.py's
    upscale/downscale smoothing).
    """

    def __init__(self, autoscaling: Optional[dict], clock=time.monotonic):
        cfg = dict(autoscaling or {})
        self.config = dict(autoscaling or {})  # identity for cache reuse
        self.min_replicas = int(cfg.get("min_replicas", 1))
        self.max_replicas = int(cfg.get("max_replicas", 8))
        self.target_ongoing_requests = float(max(
            cfg.get("target_ongoing_requests",
                    GLOBAL_CONFIG.get("serve_autoscale_target_ongoing_requests")),
            1e-3))
        self.upscale_delay_s = float(cfg.get(
            "upscale_delay_s",
            GLOBAL_CONFIG.get("serve_autoscale_upscale_delay_s")))
        self.downscale_delay_s = float(cfg.get(
            "downscale_delay_s",
            GLOBAL_CONFIG.get("serve_autoscale_downscale_delay_s")))
        # optional latency/throughput signals (LLM replicas): scale so the
        # observed quantity meets its target, proportionally to the fleet
        self.target_ttft_s = cfg.get("target_ttft_s")
        self.target_tokens_per_s = cfg.get("target_tokens_per_s")
        self._clock = clock
        self._high_since: Optional[float] = None
        self._low_since: Optional[float] = None
        self._low_peak = 0

    # -- demand -----------------------------------------------------------

    def desired_from_stats(self, stats: List[dict], running: int) -> int:
        """Raw (un-smoothed) replica demand from one round of probes."""
        load = sum(replica_load(st) for st in stats)
        if load <= 0 and not stats:
            # no live replicas answered: hold what we have rather than
            # inventing a scale-to-min on a probe blackout
            return max(running, self.min_replicas)
        desired = math.ceil(load / self.target_ongoing_requests)
        # TTFT above target: the fleet is too slow for its load — grow it
        # proportionally (2x over target -> 2x replicas), using the worst
        # replica so one hot shard can't hide behind idle peers.
        if self.target_ttft_s:
            ttfts = [st["ttft_p50_s"] for st in stats
                     if st.get("ttft_p50_s")]
            if ttfts:
                worst = max(ttfts)
                if worst > self.target_ttft_s:
                    desired = max(desired, math.ceil(
                        running * worst / float(self.target_ttft_s)))
        # aggregate decode throughput below target while loaded: each
        # replica's batch is saturated — more replicas, not bigger batches
        if self.target_tokens_per_s and load > 0:
            tps = sum(st.get("tokens_per_s") or 0.0 for st in stats)
            if stats and tps > 0 and tps < float(self.target_tokens_per_s):
                desired = max(desired, math.ceil(
                    running * float(self.target_tokens_per_s) / tps))
        return self.clamp(desired)

    def clamp(self, desired: int) -> int:
        # scale-to-zero only when the deployment opted in via min_replicas=0
        return min(max(desired, self.min_replicas), self.max_replicas)

    # -- smoothing --------------------------------------------------------

    def update(self, raw_desired: int, current_target: int,
               now: Optional[float] = None) -> int:
        """Fold one demand reading into the target (urgency + cooldown)."""
        now = self._clock() if now is None else now
        raw = self.clamp(raw_desired)
        current = self.clamp(current_target)
        if raw > current:
            self._low_since = None
            if self._high_since is None:
                self._high_since = now
            if now - self._high_since >= self.upscale_delay_s:
                self._high_since = None
                return raw
            return current
        self._high_since = None
        if raw < current:
            if self._low_since is None:
                self._low_since = now
                self._low_peak = raw
            else:
                self._low_peak = max(self._low_peak, raw)
            if now - self._low_since >= self.downscale_delay_s:
                target = self.clamp(self._low_peak)
                self._low_since = None
                return target
            return current
        self._low_since = None
        return current


# -- placement / demand helpers (pure; the controller owns all RPC) -------


def replica_shape(actor_options: dict) -> Dict[str, float]:
    """The resource shape one replica of this deployment occupies — the
    same mapping the scheduler applies to the replica's actor options."""
    from ray_tpu_torch.remote_function import build_resources

    return build_resources(dict(actor_options or {}))


def count_placeable(shape: Dict[str, float], nodes: List[dict],
                    pending: int) -> int:
    """How many of ``pending`` replicas with ``shape`` fit the cluster NOW.

    First-fit-decreasing over each ALIVE node's available resources (wire
    dicts from ``get_cluster_load``). Conservative by design: a replica
    counted placeable starts immediately; the remainder becomes reported
    demand instead of a blocking actor create that would pin the
    controller's scale lock against a 60s init timeout per misfit.
    """
    if pending <= 0:
        return 0
    need = ResourceSet({k: float(v) for k, v in (shape or {}).items() if v})
    avail = [ResourceSet.from_wire(n.get("available") or {})
             for n in nodes
             if n.get("state", "ALIVE") == "ALIVE"]
    placed = 0
    for _ in range(pending):
        for i, a in enumerate(avail):
            if need.is_subset_of(a):
                avail[i] = a - need
                placed += 1
                break
        else:
            break
    return placed


def demand_key(deployment: str) -> str:
    return f"serve:{deployment}"


def demand_shapes(shape: Dict[str, float], unplaceable: int) -> List[dict]:
    """``report_demand`` payload for the replicas that fit nowhere: one
    shape per pending replica so the node autoscaler bin-packs real sizes
    instead of a count of generic workers. Empty when everything fits —
    published as a withdrawal."""
    return [dict(shape) for _ in range(max(0, unplaceable))]
