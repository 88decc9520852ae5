"""Device meshes for the PyTorch port — counterpart of
``ray_tpu/parallel/mesh.py``.

A mesh is a ``torch.distributed.DeviceMesh`` with the JAX package's axis
names, outermost first:

    pp    — pipeline parallel
    dp    — data parallel (gradient all-reduce)
    fsdp  — fully-sharded data parallel
    tp    — tensor parallel
    sp    — sequence/context parallel (ring attention / Ulysses)

Each process is one mesh position. The processes start the default process
group themselves (``torch.distributed.init_process_group`` with an address,
a world size and a rank: the counterpart of JAX's ``jax.distributed``
bootstrap), and ``MeshSpec.build`` lays the mesh over that group, one
sub-group per axis. The port shards the batch over dp and the sequence
over sp (``models/llama.py``); fsdp / tp / pp sharding of the weights is
the sharded-training slice, not ported yet.

A gloo group's transport takes host memory only, so collectives on a gloo
group stage CUDA tensors through the host (``stage``): that is how several
ranks share one GPU, where NCCL refuses two ranks on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist

AXES = ("pp", "dp", "fsdp", "tp", "sp")

# Batch is sharded over both data axes; sequence over sp.
BATCH_AXES = ("dp", "fsdp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Axis size 1 = that parallelism disabled."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.pp, self.dp, self.fsdp, self.tp, self.sp)

    @property
    def num_devices(self) -> int:
        return self.pp * self.dp * self.fsdp * self.tp * self.sp

    def build(self):
        """A ``DeviceMesh`` with dim names ``AXES`` over the initialised
        default process group, rank r at row-major position r (sp
        innermost, as the JAX package orders devices). The group must hold
        exactly ``num_devices`` ranks. The mesh is a "cuda" one on an NCCL
        group and a "cpu" one otherwise (a gloo group moves host
        tensors)."""
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError(
                "MeshSpec.build needs torch.distributed.init_process_group "
                "first (its address, world size and rank)")
        world = dist.get_world_size()
        if world != self.num_devices:
            raise ValueError(f"mesh {self.shape} needs {self.num_devices} "
                             f"ranks, the process group has {world}")
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(device_type, self.shape, mesh_dim_names=AXES)

    @classmethod
    def for_devices(cls, n: int, tp: int = 1, sp: int = 1) -> "MeshSpec":
        """A sensible default: fill remaining devices with fsdp."""
        rest = n // (tp * sp)
        return cls(dp=1, fsdp=rest, tp=tp, sp=sp)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, as the JAX package's ``mesh.shape``; every axis 1
    for no mesh."""
    if mesh is None:
        return {a: 1 for a in AXES}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    if mesh is None or mesh_shape(mesh)[axis] == 1:
        return 0
    return mesh.get_local_rank(axis)


def stage(group) -> bool:
    """Whether collectives on ``group`` must take CUDA tensors through host
    memory: ProcessGroupGloo hands a tensor's raw pointer to its TCP
    transport."""
    return dist.get_backend(group) == "gloo"


def to_wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """``t`` as a collective on a (``staged``) group takes it: contiguous,
    and in host memory when staged."""
    t = t.contiguous()
    return t.cpu() if staged else t
