"""GPU accelerator manager: detection, visibility, resource naming.

The port's counterpart of ``ray_tpu/tpu/accelerator.py::TpuAcceleratorManager``
(itself after the reference's accelerator plugins, python/ray/_private/
accelerators/nvidia_gpu.py): TPU chips become CUDA devices.

- A node advertises ``{"GPU": n}`` and labels carrying the card's name.
- Detection for the node daemon creates no CUDA context and imports no
  torch: ``nvidia-smi -L``, else ``/proc/driver/nvidia/gpus``, then
  ``CUDA_VISIBLE_DEVICES`` narrows what was found, then the
  ``gpus_per_host`` flag overrides the count and ``gpu_visible_devices``
  keeps the ids it names (each must be among those; the daemon then writes
  them into every worker's ``CUDA_VISIBLE_DEVICES``). Only a worker may
  probe through torch (``allow_cuda_probe``), as only a TPU worker may
  probe through JAX.
- One worker process owns the devices it was granted; a subset is written
  to ``CUDA_VISIBLE_DEVICES`` at spawn, and a worker granted every device
  of the node keeps the env it had.
- An NVLink domain is what a TPU slice is to the JAX package: the hosts
  whose devices share one NVLink fabric, which gang placement reserves
  whole (``gpu/slice.py``). A node is a domain of its own (``1x<devices>``)
  unless configuration names a shared one: the ``gpu_topology`` flag (or
  ``GPU_TOPOLOGY``) gives ``HxG``, ``GPU_DOMAIN_NAME`` the domain and
  ``GPU_WORKER_ID`` this host's index in it. Host 0 of a domain carries its
  reservation token, as the JAX package's slice head does.

The JAX package's names (``ray_tpu/tpu/accelerator.py``) and theirs here:

=============================  ====================================
JAX package (TPU)              port (GPU)
=============================  ====================================
``TPU`` resource               ``GPU`` resource
``TPU-{pod_type}-head``        ``GPU-{pod_type}-head`` (host 0)
``tpu-pod-type`` label         ``gpu-pod-type`` (``H100-8``)
``tpu-slice-name`` label       ``gpu-domain-name``
``tpu-worker-id`` label        ``gpu-worker-id``
``tpu-topology`` label         ``gpu-topology`` (``HxG``)
``rt.tpu.coord`` label         ``rt.gpu.coord`` (``0,<worker id>``)
``tpu_topology`` flag          ``gpu_topology`` flag
``TPU_NAME`` env               ``GPU_DOMAIN_NAME``
``TPU_WORKER_ID`` env          ``GPU_WORKER_ID``
``TPU_TOPOLOGY`` env           ``GPU_TOPOLOGY``
=============================  ====================================

``pod_type`` is ``{model}-{devices in the domain}``, the model the card
name's first token with a digit (``NVIDIA H100 80GB HBM3`` -> ``H100``;
``gpu`` when the name is unknown).
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import GLOBAL_CONFIG

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
GPU_DOMAIN_NAME_ENV = "GPU_DOMAIN_NAME"
GPU_WORKER_ID_ENV = "GPU_WORKER_ID"
GPU_TOPOLOGY_ENV = "GPU_TOPOLOGY"
_PROC_GPUS = "/proc/driver/nvidia/gpus"


def parse_topology(topology: str) -> Tuple[int, int]:
    """``"HxG"`` as (hosts, devices a host)."""
    m = re.fullmatch(r"\s*(\d+)\s*x\s*(\d+)\s*", topology or "")
    if not m or int(m.group(1)) < 1 or int(m.group(2)) < 1:
        raise ValueError(
            f"GPU topology {topology!r} is not 'HxG' (hosts x devices a host)")
    return int(m.group(1)), int(m.group(2))


def model_of(name: str) -> str:
    """The card's model from its name: its first token with a digit,
    before any '-' ("NVIDIA H100 80GB HBM3" -> "H100")."""
    for tok in name.replace("-", " ").split():
        if any(c.isdigit() for c in tok):
            return tok
    return "gpu"


@dataclass
class GpuInfo:
    device_ids: List[int]      # physical ids this node grants
    name: str = ""             # e.g. "NVIDIA H100 80GB HBM3"; "" if unknown
    topology: str = ""         # "HxG" of the NVLink domain; "" = this node
    domain_name: str = ""      # the domain's name; "" = this node's own
    worker_id: int = 0         # this host's index in the domain

    @property
    def count(self) -> int:
        return len(self.device_ids)

    @property
    def domain_topology(self) -> str:
        return self.topology or f"1x{self.count}"

    @property
    def pod_type(self) -> str:
        hosts, per_host = parse_topology(self.domain_topology)
        return f"{model_of(self.name)}-{hosts * per_host}"

    @property
    def head_resource_name(self) -> str:
        return f"GPU-{self.pod_type}-head"


def _nvidia_smi() -> List[Tuple[int, str, str]]:
    """(index, name, uuid) per device from ``nvidia-smi -L``; [] when the
    tool is missing or fails. Reading the list opens no CUDA context."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return []
    if out.returncode != 0:
        return []
    devs = []
    for line in out.stdout.splitlines():
        m = re.match(r"GPU (\d+): (.+?) \(UUID: ([^)]+)\)", line.strip())
        if m:
            devs.append((int(m.group(1)), m.group(2), m.group(3)))
    return devs


def _proc_gpus() -> List[Tuple[int, str, str]]:
    """The driver's own list, in PCI order (nvidia-smi's default order)."""
    try:
        buses = sorted(os.listdir(_PROC_GPUS))
    except OSError:
        return []
    devs = []
    for i, bus in enumerate(buses):
        name = uuid = ""
        try:
            with open(os.path.join(_PROC_GPUS, bus, "information")) as f:
                for line in f:
                    key, _, val = line.partition(":")
                    if key.strip() == "Model":
                        name = val.strip()
                    elif key.strip() == "GPU UUID":
                        uuid = val.strip()
        except OSError:
            pass
        devs.append((i, name, uuid))
    return devs


def _narrow_to_visible(devs, visible: str):
    """Keep the devices ``CUDA_VISIBLE_DEVICES`` names (ids or UUIDs), in
    its order; the parse stops at the first unknown entry, as CUDA's does."""
    kept = []
    for tok in (t.strip() for t in visible.split(",")):
        hit = [d for d in devs if (tok.isdigit() and d[0] == int(tok))
               or (tok and not tok.isdigit() and d[2].startswith(tok))]
        if not hit:
            break
        kept.append(hit[0])
    return kept


class GpuAcceleratorManager:
    """Detection + env handling for the node daemon and worker pool."""

    @staticmethod
    def detect(allow_cuda_probe: bool = True) -> Optional[GpuInfo]:
        """The node's CUDA devices, or None. ``allow_cuda_probe=False`` for
        the node daemon: asking torch would create a CUDA context in the
        daemon, on the devices its workers are granted."""
        devs = _nvidia_smi() or _proc_gpus()
        if not devs and allow_cuda_probe:
            try:
                import torch

                devs = [(i, torch.cuda.get_device_name(i), "")
                        for i in range(torch.cuda.device_count())]
            except Exception:  # noqa: BLE001 — no torch or no driver
                devs = []
        visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if visible is not None:
            devs = _narrow_to_visible(devs, visible)
        ids = [d[0] for d in devs]
        names = {d[0]: d[1] for d in devs}
        n = GLOBAL_CONFIG.get("gpus_per_host")
        if n:
            ids = (ids + [i for i in range(n + len(ids)) if i not in ids])[:n]
        wanted = GLOBAL_CONFIG.get("gpu_visible_devices")
        if wanted:
            named = [int(t) for t in wanted.split(",") if t.strip()]
            unknown = [i for i in named if i not in ids]
            if unknown:
                raise ValueError(
                    f"gpu_visible_devices names {unknown}, not among the "
                    f"node's CUDA devices {ids}")
            ids = named
        if not ids:
            return None
        topology = GLOBAL_CONFIG.get("gpu_topology") or os.environ.get(
            GPU_TOPOLOGY_ENV, "")
        if topology:
            parse_topology(topology)
        return GpuInfo(device_ids=ids, name=names.get(ids[0], ""),
                       topology=topology,
                       domain_name=os.environ.get(GPU_DOMAIN_NAME_ENV, ""),
                       worker_id=int(os.environ.get(GPU_WORKER_ID_ENV, "0")))

    @staticmethod
    def node_resources_and_labels(info: Optional[GpuInfo] = None):
        """Resources + labels the node daemon should advertise."""
        from ray_tpu_torch._private.protocol import GPU_COORD_LABEL

        info = info or GpuAcceleratorManager.detect()
        if info is None:
            return {}, {}
        resources = {"GPU": float(info.count)}
        if info.worker_id == 0:
            resources[info.head_resource_name] = 1.0
        labels = {
            "gpu-count": str(info.count),
            "gpu-pod-type": info.pod_type,
            # a domain of its own is named after its host and devices
            "gpu-domain-name": info.domain_name or (
                f"{info.pod_type}-{socket.gethostname()}-"
                + "-".join(map(str, info.device_ids))),
            "gpu-worker-id": str(info.worker_id),
            "gpu-topology": info.domain_topology,
            GPU_COORD_LABEL: f"0,{info.worker_id}",
        }
        if info.name:
            labels["gpu-name"] = info.name
        return resources, labels

    @staticmethod
    def set_visible_devices_env(env: Dict[str, str], device_ids: List[int],
                                devices_per_host: int) -> None:
        """Restrict a worker process to specific devices (TPU_VISIBLE_CHIPS'
        rule, with CUDA's variable). With every device granted, the env is
        left as it was: the worker owns the node's devices."""
        if len(device_ids) >= devices_per_host:
            return
        env[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(d) for d in device_ids)
