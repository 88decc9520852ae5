"""ray_tpu_torch.util.collective — out-of-band collectives on NCCL and gloo.

Reference: python/ray/util/collective/ (NCCL/GLOO backends). The port's
copy of ``ray_tpu/util/collective``: the same registry and functions, with
``nccl_group.NcclCollectiveGroup`` in place of the JAX package's
``XlaCollectiveGroup``.
"""

from ray_tpu_torch.util.collective.collective import (
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    permute,
    recv,
    reduce,
    reducescatter,
    send,
)
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

__all__ = [
    "init_collective_group", "destroy_collective_group", "is_group_initialized",
    "get_rank", "get_collective_group_size",
    "allreduce", "reduce", "broadcast", "allgather", "reducescatter",
    "send", "recv", "permute", "barrier", "Backend", "ReduceOp",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("collective")
del _rlu
