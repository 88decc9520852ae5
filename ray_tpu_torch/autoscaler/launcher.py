"""Config-driven cluster launcher: the `rt up` / `rt down` path.

The port's counterpart of ``ray_tpu/autoscaler/launcher.py``: the same YAML
keys with the same defaults; provider `local` builds `SliceNodeProvider`,
provider `gcp` builds `gcp.GpuVmNodeProvider` (GCE GPU VMs). The gcp
provider's `runtime_version` (a TPU VM image there) has no GPU meaning: it
is accepted and unused.

Reference surface: python/ray/autoscaler/_private/commands.py (ray up —
create_or_update_cluster from a YAML config) and the config schema in
python/ray/autoscaler/ray-schema.json, reduced to this framework's shape:
the head (control store + head daemon) starts on the invoking machine and
an Autoscaler reconciles workers/slices through the configured provider.

YAML shape:

    cluster_name: demo
    provider:
      type: local            # or: gcp
      project: my-project    # gcp only
      zone: us-central1-a    # gcp only
      machine_type: a3-highgpu-1g
    head:
      resources: {CPU: 4}
      labels: {zone: head}
    workers:
      resources: {CPU: 4, GPU: 1}
      min_workers: 0
      max_workers: 4
      idle_timeout_s: 60
    slice_types:
      H100-8:
        hosts: 1
        resources_per_host: {CPU: 8, GPU: 8}
    max_slices: 2
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ray_tpu_torch.autoscaler import (
    Autoscaler,
    AutoscalingConfig,
    SliceNodeProvider,
    SliceSpec,
)

logger = logging.getLogger(__name__)


def load_cluster_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, encoding="utf-8") as f:
        cfg = yaml.safe_load(f) or {}
    if "cluster_name" not in cfg:
        raise ValueError(f"{path}: cluster_name is required")
    cfg.setdefault("provider", {"type": "local"})
    cfg.setdefault("head", {})
    cfg.setdefault("workers", {})
    cfg.setdefault("slice_types", {})
    return cfg


def _build_provider(cfg: Dict[str, Any], control_address: str,
                    session_dir: str, transport=None):
    ptype = cfg["provider"].get("type", "local")
    if ptype == "local":
        return SliceNodeProvider(control_address, session_dir)
    if ptype == "gcp":
        from ray_tpu_torch.autoscaler.gcp import GpuVmNodeProvider

        p = cfg["provider"]
        if not p.get("project") or not p.get("zone"):
            raise ValueError("gcp provider needs project + zone")
        return GpuVmNodeProvider(
            project=p["project"], zone=p["zone"],
            control_address=control_address,
            transport=transport,
            machine_type=p.get("machine_type", "n2-standard-8"),
            cluster_name=cfg["cluster_name"],
        )
    raise ValueError(f"unknown provider type {ptype!r}")


def _autoscaling_config(cfg: Dict[str, Any]) -> AutoscalingConfig:
    w = cfg["workers"]
    slice_types = {
        name: SliceSpec(
            hosts=int(s.get("hosts", 2)),
            resources_per_host=dict(
                s.get("resources_per_host", {"CPU": 1.0, "GPU": 1.0})),
        )
        for name, s in (cfg.get("slice_types") or {}).items()
    }
    return AutoscalingConfig(
        min_workers=int(w.get("min_workers", 0)),
        max_workers=int(w.get("max_workers", 2)),
        worker_resources=dict(w.get("resources", {"CPU": 2.0})),
        idle_timeout_s=float(w.get("idle_timeout_s", 60.0)),
        slice_types=slice_types,
        max_slices=int(cfg.get("max_slices", 4)),
    )


@dataclass
class LaunchedCluster:
    config: Dict[str, Any]
    control_address: str
    session_dir: str
    autoscaler: Autoscaler
    head_procs: list

    def shutdown(self, terminate_workers: bool = True):
        from ray_tpu_torch._private import node as node_mod

        self.autoscaler.stop(terminate_workers=terminate_workers)
        for proc in self.head_procs:
            node_mod.kill_process(proc)


def cluster_up(cfg: Dict[str, Any], *, transport=None,
               connect: bool = True) -> LaunchedCluster:
    """Start head processes + the autoscaler loop for `cfg`. `transport`
    overrides the GCP HTTP transport (tests pass FakeGcpTransport)."""
    import ray_tpu_torch
    from ray_tpu_torch._private import node as node_mod

    session_dir = node_mod.new_session_dir()
    cs_proc, control_address = node_mod.start_control_store(session_dir)
    head = cfg.get("head") or {}
    nd_proc, _info = node_mod.start_node_daemon(
        control_address, session_dir,
        resources=dict(head.get("resources") or {}) or None,
        labels=dict(head.get("labels") or {}) or None,
    )
    if connect:
        ray_tpu_torch.init(address=control_address)
    provider = _build_provider(cfg, control_address, session_dir, transport)
    autoscaler = Autoscaler(provider, _autoscaling_config(cfg)).start()
    logger.info("cluster %s up at %s", cfg["cluster_name"], control_address)
    return LaunchedCluster(
        config=cfg, control_address=control_address,
        session_dir=session_dir, autoscaler=autoscaler,
        head_procs=[cs_proc, nd_proc])


def save_launch_state(cluster: LaunchedCluster, path: str):
    with open(path, "w", encoding="utf-8") as f:
        json.dump({
            "cluster_name": cluster.config["cluster_name"],
            "address": cluster.control_address,
            "session_dir": cluster.session_dir,
            "head_pids": [p.pid for p in cluster.head_procs],
        }, f)


__all__ = [
    "LaunchedCluster",
    "cluster_up",
    "load_cluster_config",
    "save_launch_state",
]
