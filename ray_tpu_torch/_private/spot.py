"""Spot-aware placement for singleton/critical actors.

One shared implementation of the r12 anti-spot pattern (first grown for
the elastic-train SyncActor): coordination singletons — serve controller,
JobManager, job supervisors, control-store standby, the rendezvous
SyncActor — and the LAST replica of a serve deployment prefer non-spot
capacity via the negated label selector `{"spot": "!true", "preemptible":
"!true"}` (reference: pb.labels_match's "!value" anti-affinity path), so a
correlated spot-reclaim wave cannot take out the fleet's control points
alongside its worker capacity.

The preference degrades gracefully: when every usable node carries the
spot/preemptible marker the selector is dropped — an all-spot cluster must
still run. The decision is made from a SNAPSHOT of the node table; callers
placing into a shrinking cluster should pair it with a feasibility
re-probe on placement timeout (see WorkerGroup.create for the pattern).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, Optional

logger = logging.getLogger(__name__)

# the negated-selector form pb.labels_match treats as anti-affinity
ANTI_SPOT_SELECTOR: Dict[str, str] = {"spot": "!true", "preemptible": "!true"}


def is_spot_node(n: dict) -> bool:
    """Whether a node-table row advertises reclaimable capacity (daemon
    mirrors the `spot` custom resource into labels at registration)."""
    labels = n.get("labels") or {}
    return (labels.get("spot") == "true"
            or labels.get("preemptible") == "true")


def anti_spot_placement(what: str = "actor",
                        nodes: Optional[Iterable[dict]] = None
                        ) -> Dict[str, Any]:
    """Options fragment pinning `what` off spot capacity, or `{}`.

    Returns `{"label_selector": ANTI_SPOT_SELECTOR}` unless every usable
    (ALIVE, not draining) node carries the spot marker — then `{}` with a
    warning, the all-spot fallback. Pass `nodes` to decide from a caller's
    snapshot; otherwise the live node table is fetched (and an unreachable
    control store yields unconstrained placement rather than an error)."""
    if nodes is None:
        import asyncio

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass
        else:
            # called from a running event loop: the sync node fetch below
            # would deadlock it — callers there must use the async variant
            # (unconstrained placement beats a wedged loop)
            logger.warning(
                "anti_spot_placement called on an event loop for %s — "
                "use anti_spot_placement_async; placing unconstrained", what)
            return {}
        try:
            from ray_tpu_torch._private.worker import nodes as _nodes

            nodes = _nodes()
        except Exception:  # noqa: BLE001 — control store unreachable
            return {}
    usable = [n for n in nodes
              if n.get("state") == "ALIVE" and not n.get("drain_reason")]
    if usable and all(is_spot_node(n) for n in usable):
        logger.warning(
            "every usable node carries the spot/preemptible marker — "
            "placing %s on spot capacity", what)
        return {}
    return {"label_selector": dict(ANTI_SPOT_SELECTOR)}


async def anti_spot_placement_async(what: str = "actor") -> Dict[str, Any]:
    """Loop-safe variant for code running on the core event loop (async
    actors — e.g. the serve controller scaling replicas): a blocking
    `worker.nodes()` there would deadlock the loop it needs."""
    try:
        from ray_tpu_torch._private.core_worker import get_core_worker
        from ray_tpu_torch._private.protocol import NodeInfo

        cw = get_core_worker()
        # short timeout: callers sit on critical reconcile paths (the serve
        # controller holds _scale_lock here) — a wedged control store must
        # degrade to unconstrained placement, not freeze replica creation
        reply = await cw.control.call("get_all_nodes", {}, timeout=2)
        rows = []
        for w in reply.get("nodes", ()):
            info = NodeInfo.from_wire(w)
            rows.append({"state": info.state, "labels": info.labels,
                         "drain_reason": info.drain_reason})
    except Exception:  # noqa: BLE001 — control store unreachable
        return {}
    return anti_spot_placement(what, nodes=rows)


__all__ = [
    "ANTI_SPOT_SELECTOR",
    "anti_spot_placement",
    "anti_spot_placement_async",
    "is_spot_node",
]
