"""Device-native channel: a compiled-graph edge that carries tensors
device to device through a collective ``permute`` instead of host
serialization. The port's copy of ``ray_tpu/experimental/device_channel.py``.

Reference surface: python/ray/experimental/channel/
torch_tensor_accelerator_channel.py (NCCL p2p channels between accelerator
workers inside compiled DAGs). A device edge is a RENDEZVOUS: both endpoint
processes enter the same two-member ``permute`` of a collective group
(``ray_tpu_torch.util.collective``), which moves the payload over NVLink
under NCCL, or through host memory under gloo. The host shm/RPC channel
plane remains the fallback for edges that leave the gang
(``ray_tpu_torch/experimental/channel.py``).

Contract: write(src side) and read(dst side) are the two halves of ONE
collective call, so the endpoints must invoke them in matching order —
exactly what a compiled DAG's static per-actor schedules guarantee
(reference: compiled_dag_node.py orders NCCL sends/recvs the same way).
The reader declares shape/dtype up front (channels are typed, like the
reference's TorchTensorType annotation), so no metadata round-trip is
needed at transfer time.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple


def _torch_dtype(dtype: Any):
    """A torch dtype from a torch dtype, a numpy dtype (or anything
    ``np.dtype`` takes) or a torch dtype's name."""
    import numpy as np
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class DeviceChannel:
    """One directed device edge between two members of a collective group
    (ray_tpu_torch.util.collective, backend "nccl" or "gloo").

    Every rank of the group participates in the underlying permute
    (collectives are group-wide); use dedicated 2-member groups per edge —
    the natural shape for pipeline-stage handoffs — so a transfer only
    synchronizes its endpoints. ``read`` returns a tensor on ``device``:
    the group's device unless given (its CUDA device under NCCL, the CPU
    under gloo; a gloo edge may name a CUDA device, and then carries the
    payload staged through host memory).
    """

    def __init__(self, group_name: str, src_rank: int, dst_rank: int,
                 shape: Tuple[int, ...], dtype: Any, device: Optional[Any] = None):
        if src_rank == dst_rank:
            raise ValueError("device channel endpoints must differ")
        self.group_name = group_name
        self.src_rank = src_rank
        self.dst_rank = dst_rank
        self.shape = tuple(shape)
        self.dtype = _torch_dtype(dtype)
        self.device = device

    def _device(self):
        import torch

        if self.device is not None:
            return torch.device(self.device)
        from ray_tpu_torch.util.collective.collective import _manager

        return _manager.get(self.group_name).device

    def _permute(self, contribution):
        from ray_tpu_torch.util import collective as col

        return col.permute(contribution,
                           [(self.src_rank, self.dst_rank)],
                           group_name=self.group_name)

    def write(self, arr) -> None:
        """Producer half: contribute the payload (cast to the channel's
        dtype, as the JAX package's ``jnp.asarray`` does). Blocks until the
        consumer enters its matching read (collective semantics — this IS
        the channel's backpressure)."""
        import torch

        arr = torch.as_tensor(arr, dtype=self.dtype)
        if tuple(arr.shape) != self.shape:
            raise ValueError(
                f"device channel is typed {self.shape}/{self.dtype}; "
                f"got {tuple(arr.shape)}/{arr.dtype}")
        self._permute(arr)

    def read(self):
        """Consumer half: contribute zeros, receive the producer's
        payload as a tensor on the channel's device."""
        import torch

        return self._permute(torch.zeros(self.shape, dtype=self.dtype,
                                         device=self._device()))


__all__ = ["DeviceChannel"]
