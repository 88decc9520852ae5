"""NVLink-domain orchestration: whole-domain reservation + per-host dispatch.

The port's counterpart of the JAX package's ``ray_tpu/tpu/slice.py`` (TPU
slices; reference: python/ray/util/tpu.py — SlicePlacementGroup :421,
slice_placement_group :803, dispatch :849, get_tpu_coordinator_env_vars
:213). What a TPU slice is there, an NVLink domain is here: the hosts whose
CUDA devices share one NVLink fabric (one 8-GPU node, or an NVL72 rack of
18 hosts of 4), labelled by ``gpu/accelerator.py``.

A reservation works in two stages, as in the JAX package:
1. grab one ``GPU-{pod_type}-head: 1`` per domain — the head resource exists
   on exactly one host per domain (host 0), so owning it owns the domain;
2. resolve each claimed head's ``gpu-domain-name`` node label and gang that
   domain's per-host GPU bundles with a ``bundle_label_selector`` pinning
   them to the domain's own hosts (``TOPOLOGY_STRICT_PACK`` where enough of
   them carry ``rt.gpu.coord``, STRICT_SPREAD otherwise). On clusters whose
   nodes carry no domain labels, stage 2 falls back to an unpinned gang.

``dispatch`` injects the cross-domain coordinator env into every host's task
for multi-domain reservations (coordinator = domain 0's head host). The
keys, the counterparts of the JAX package's MEGASCALE_* ones:

- ``RT_GPU_DOMAIN_COORDINATOR`` — ``host:port`` of domain 0's head host
  (MEGASCALE_COORDINATOR_ADDRESS);
- ``RT_GPU_NUM_DOMAINS`` — the domains reserved (MEGASCALE_NUM_SLICES);
- ``RT_GPU_DOMAIN_ID`` — this host's domain, 0-based (MEGASCALE_SLICE_ID);
- ``RT_GPU_DOMAIN_PORT`` — the coordinator's port (MEGASCALE_PORT).

``slice_placement_group`` takes the ``topology`` a ``ScalingConfig`` names
(``"HxG"``: H hosts of G devices), so the train library's call carries it.
(The JAX package's worker group passes ``topology=`` to a
``slice_placement_group`` that takes none, a ``TypeError``.)
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.protocol import GPU_COORD_LABEL
from ray_tpu_torch.gpu.accelerator import parse_topology
from ray_tpu_torch.util.placement_group import PlacementGroup, placement_group

logger = logging.getLogger(__name__)

DOMAIN_COORDINATOR = "RT_GPU_DOMAIN_COORDINATOR"
NUM_DOMAINS = "RT_GPU_NUM_DOMAINS"
DOMAIN_ID = "RT_GPU_DOMAIN_ID"
DOMAIN_PORT = "RT_GPU_DOMAIN_PORT"


def get_gpu_coordinator_env_vars(
    coordinator_address: str, num_slices: int, slice_id: int,
    port: int = 8081,
) -> Dict[str, str]:
    """Env to inject into every worker of a multi-domain job."""
    if num_slices <= 1:
        return {}
    return {
        DOMAIN_COORDINATOR: coordinator_address,
        NUM_DOMAINS: str(num_slices),
        DOMAIN_ID: str(slice_id),
        DOMAIN_PORT: str(port),
    }


@dataclass
class SlicePlacementGroup:
    """Reservation of one or more whole NVLink domains."""

    pod_type: str                   # e.g. "H100-8" (a node's gpu-pod-type)
    num_slices: int = 1
    gpus_per_host: int = 8
    hosts_per_slice: int = 1
    coordinator_port: int = 8081
    _head_pg: Optional[PlacementGroup] = None
    _slice_pgs: List[PlacementGroup] = field(default_factory=list)
    _slice_names: List[Optional[str]] = field(default_factory=list)
    _coordinator: str = ""

    def reserve(self) -> "SlicePlacementGroup":
        head_resource = f"GPU-{self.pod_type}-head"
        self._head_pg = placement_group(
            [{head_resource: 1.0} for _ in range(self.num_slices)],
            strategy="STRICT_SPREAD" if self.num_slices > 1 else "PACK",
            name=f"slice-head:{self.pod_type}",
        )
        return self

    def ready(self, timeout: float = 120.0) -> bool:
        if self._head_pg is None or not self._head_pg.ready(timeout):
            return False
        if not self._slice_pgs:
            self._create_slice_pgs()
        return all(pg.ready(timeout) for pg in self._slice_pgs)

    def _create_slice_pgs(self):
        """Stage 2: pin per-host gangs to the claimed domains via node labels."""
        import ray_tpu_torch

        placements = self._head_pg.bundle_placements()
        node_info = {n["node_id"]: n for n in ray_tpu_torch.nodes()}
        bundles = [
            {"GPU": float(self.gpus_per_host)}
            for _ in range(self.hosts_per_slice)
        ]
        for slice_idx in range(self.num_slices):
            head_node = node_info.get(placements.get(slice_idx, ""), {})
            labels = head_node.get("labels", {})
            domain = labels.get("gpu-domain-name")
            self._slice_names.append(domain)
            if slice_idx == 0 and head_node:
                host = head_node.get("address", "").rsplit(":", 1)[0]
                self._coordinator = f"{host}:{self.coordinator_port}"
            selector = {"gpu-domain-name": domain} if domain else None
            # multi-host gangs use topology-aware placement when ENOUGH
            # in-scope hosts advertise coordinates (rt.gpu.coord) to place
            # every bundle — a partial label rollout must fall back to
            # STRICT_SPREAD, not time out on an unplaceable topology PG
            # (reference: topology_bundle_scheduling_policy.h:89)
            labeled_in_scope = sum(
                1 for n in node_info.values()
                if GPU_COORD_LABEL in n.get("labels", {})
                and (not domain
                     or n.get("labels", {}).get("gpu-domain-name") == domain)
            )
            if self.hosts_per_slice <= 1:
                strategy = "PACK"
            elif labeled_in_scope >= self.hosts_per_slice:
                strategy = "TOPOLOGY_STRICT_PACK"
            else:
                strategy = "STRICT_SPREAD"
            self._slice_pgs.append(placement_group(
                bundles,
                strategy=strategy,
                name=f"slice:{self.pod_type}:{slice_idx}",
                bundle_label_selector=selector,
            ))

    @property
    def placement_group(self) -> PlacementGroup:
        """The domain-0 gang PG (after ready())."""
        return self._slice_pgs[0] if self._slice_pgs else self._head_pg

    def remove(self):
        from ray_tpu_torch.util.placement_group import remove_placement_group

        for pg in [*self._slice_pgs, self._head_pg]:
            if pg is not None:
                remove_placement_group(pg)

    def dispatch(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run `fn` once per host of every domain (reference: tpu.py:849).

        Returns one ObjectRef per host, domain-major. For multi-domain
        reservations the cross-domain env rides each task's runtime_env
        (coordinator = domain 0's head host). A host's task holds the
        host's GPUs (its bundle)."""
        import ray_tpu_torch

        if not self.ready():
            raise RuntimeError("slice placement group is not ready")
        remote_fn = ray_tpu_torch.remote(fn) if not hasattr(fn, "remote") else fn
        refs = []
        for slice_idx, pg in enumerate(self._slice_pgs):
            env = get_gpu_coordinator_env_vars(
                self._coordinator, self.num_slices, slice_idx,
                self.coordinator_port,
            )
            for host_index in range(self.hosts_per_slice):
                refs.append(
                    remote_fn.options(
                        num_cpus=0,  # the bundle reserves GPUs, not CPU
                        resources={"GPU": float(self.gpus_per_host)},
                        placement_group=pg,
                        placement_group_bundle_index=host_index,
                        runtime_env={"env_vars": env} if env else None,
                    ).remote(*args, **kwargs)
                )
        return refs


def slice_placement_group(pod_type: str, num_slices: int = 1,
                          gpus_per_host: Optional[int] = None,
                          hosts_per_slice: Optional[int] = None,
                          topology: str = "") -> SlicePlacementGroup:
    """Reserve `num_slices` whole NVLink domains of `pod_type` (reference:
    tpu.py:803). ``topology`` ("HxG") gives the hosts a domain and the
    devices a host; without it a domain is one host holding every device
    the pod type counts ("H100-8": 8)."""
    if not pod_type:
        raise ValueError(
            "a domain reservation needs the pod type (a node's gpu-pod-type "
            "label, e.g. 'H100-8'; ScalingConfig's accelerator_type)")
    if topology:
        hosts, per_host = parse_topology(topology)
        if hosts_per_slice not in (None, hosts) or gpus_per_host not in (
                None, per_host):
            raise ValueError(
                f"topology {topology!r} disagrees with hosts_per_slice="
                f"{hosts_per_slice}, gpus_per_host={gpus_per_host}")
    else:
        hosts = hosts_per_slice or 1
        m = re.search(r"-(\d+)$", pod_type)
        total = int(m.group(1)) if m else 8
        per_host = gpus_per_host or max(1, total // hosts)
    return SlicePlacementGroup(
        pod_type=pod_type,
        num_slices=num_slices,
        gpus_per_host=per_host,
        hosts_per_slice=hosts,
    ).reserve()
