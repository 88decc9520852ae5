"""Placement groups: gang-scheduled resource bundles. The port's copy of
``ray_tpu/util/placement_group.py``: a bundle's ``"GPU"`` is accounted in
floats, and a lease in it binds ``int(n)`` devices, as a task's lease does.

Capability parity with the reference's placement group API (reference:
python/ray/util/placement_group.py — placement_group(), PlacementGroup.ready(),
remove_placement_group; scheduling semantics from
src/ray/raylet/scheduling/policy/bundle_scheduling_policy.h:74-101 and the GCS
2PC prepare/commit protocol node_manager.proto:515-525).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.core_worker import get_core_worker
from ray_tpu_torch._private.errors import PlacementGroupUnschedulableError
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.protocol import (
    PG_CREATED,
    PG_PACK,
    PG_REMOVED,
    Bundle,
    ResourceSet,
)


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundle_specs = bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def _state(self) -> Optional[dict]:
        cw = get_core_worker()
        reply = cw.run_sync(
            cw.control.call("get_placement_group", {"pg_id": self.id.binary()})
        )
        return reply["pg"]

    def ready(self, timeout: float = 60.0) -> bool:
        """Block until the gang reservation commits (or fails)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self._state()
            if st is None:
                return False
            if st["state"] == PG_CREATED:
                return True
            if st["state"] == PG_REMOVED:
                raise PlacementGroupUnschedulableError(
                    f"placement group {self.id.hex()[:12]} could not be scheduled"
                )
            time.sleep(0.05)
        return False

    def bundle_placements(self) -> Dict[int, str]:
        """Bundle index -> node id hex (after ready())."""
        st = self._state()
        if not st:
            return {}
        return {int(k): v.hex() if isinstance(v, bytes) else v
                for k, v in st["placements"].items()}

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = PG_PACK,
    name: str = "",
    bundle_label_selector: Optional[Dict[str, str]] = None,
) -> PlacementGroup:
    """Gang-reserve resource bundles. `bundle_label_selector` restricts all
    bundles to nodes whose labels match (reference: label_selector scheduling,
    src/ray/common/scheduling/label_selector.h:73)."""
    cw = get_core_worker()
    pg_id = PlacementGroupID.from_random()
    wire_bundles = [
        Bundle(index=i, resources=ResourceSet(b)).to_wire()
        for i, b in enumerate(bundles)
    ]
    cw.run_sync(
        cw.control.call(
            "create_placement_group",
            {
                "pg_id": pg_id.binary(),
                "bundles": wire_bundles,
                "strategy": strategy,
                "name": name,
                "labels": bundle_label_selector or {},
            },
        )
    )
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    cw = get_core_worker()
    cw.run_sync(cw.control.call("remove_placement_group", {"pg_id": pg.id.binary()}))
