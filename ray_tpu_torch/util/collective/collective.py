"""Collective communication API.

Capability parity with the reference's surface (reference:
python/ray/util/collective/collective.py — init_collective_group :149,
allreduce :312, barrier :352, reduce :362, broadcast :421, allgather :468,
reducescatter :511, send :567, recv :624, GroupManager :65). The port's
copy of ``ray_tpu/util/collective/collective.py``: the same signatures, with
the reference's NCCL and GLOO backends where the JAX package has XLA
(NCCL by default, as XLA is there).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.util.collective.types import Backend, GroupInfo, ReduceOp
from ray_tpu_torch.util.collective.nccl_group import NcclCollectiveGroup


class GroupManager:
    """Process-local registry of collective groups (reference: :65)."""

    def __init__(self):
        self._groups: Dict[str, NcclCollectiveGroup] = {}
        self._lock = threading.Lock()

    def create(self, world_size: int, rank: int, backend: str,
               group_name: str) -> NcclCollectiveGroup:
        backend = Backend.validate(backend)
        with self._lock:
            if group_name in self._groups:
                raise ValueError(f"collective group {group_name!r} already exists")
        group = NcclCollectiveGroup(world_size, rank, group_name, backend)
        with self._lock:
            self._groups[group_name] = group
        return group

    def get(self, group_name: str) -> NcclCollectiveGroup:
        with self._lock:
            group = self._groups.get(group_name)
        if group is None:
            raise ValueError(
                f"collective group {group_name!r} is not initialized in this "
                f"process; call init_collective_group first"
            )
        return group

    def destroy(self, group_name: str):
        with self._lock:
            group = self._groups.pop(group_name, None)
        if group is not None:
            group.destroy()


_manager = GroupManager()


def init_collective_group(world_size: int, rank: int, backend: str = Backend.NCCL,
                          group_name: str = "default") -> None:
    """Initialize this process's membership in a collective group.

    Must be called by every member (typically inside each actor). Rank 0
    publishes the group's TCPStore through the control store. NCCL (the
    default) needs CUDA; gloo runs in host memory.
    """
    _manager.create(world_size, rank, backend, group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    _manager.destroy(group_name)


def is_group_initialized(group_name: str = "default") -> bool:
    try:
        _manager.get(group_name)
        return True
    except ValueError:
        return False


def get_rank(group_name: str = "default") -> int:
    return _manager.get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get(group_name).world_size


def allreduce(tensor, op: str = ReduceOp.SUM, group_name: str = "default"):
    return _manager.get(group_name).allreduce(tensor, op)


def reduce(tensor, dst_rank: int = 0, op: str = ReduceOp.SUM,
           group_name: str = "default"):
    return _manager.get(group_name).reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _manager.get(group_name).broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default"):
    return _manager.get(group_name).allgather(tensor)


def reducescatter(tensor, op: str = ReduceOp.SUM, group_name: str = "default"):
    return _manager.get(group_name).reducescatter(tensor, op)


def send(tensor, dst_rank: int, group_name: str = "default"):
    _manager.get(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default", timeout: float = 60.0):
    return _manager.get(group_name).recv(src_rank, timeout)


def permute(tensor, perm, group_name: str = "default"):
    """Device-plane collective point-to-point: every rank calls; rank d
    receives rank s's tensor for each (s, d) in perm (zeros elsewhere) —
    paired sends and receives on the group's backend (NVLink under NCCL;
    host-plane send/recv stays for true out-of-band transfers)."""
    return _manager.get(group_name).permute(tensor, perm)


def barrier(group_name: str = "default"):
    _manager.get(group_name).barrier()
