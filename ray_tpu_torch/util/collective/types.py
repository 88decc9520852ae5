"""Collective types (reference: python/ray/util/collective/types.py:34 —
the Backend enum NCCL/GLOO). The port's copy of
``ray_tpu/util/collective/types.py``: its backends are the reference's
own, NCCL on CUDA devices and gloo in host memory; the JAX package's XLA
backend is refused here, as that package refuses NCCL."""

from __future__ import annotations

from dataclasses import dataclass


class Backend:
    NCCL = "nccl"      # ProcessGroupNCCL on the rank's current CUDA device
    GLOO = "gloo"      # ProcessGroupGloo: host memory (CUDA tensors staged)
    XLA = "xla"        # the JAX package's backend: not in the port

    @staticmethod
    def validate(name: str) -> str:
        name = name.lower()
        if name in (Backend.NCCL, Backend.GLOO):
            return name
        if name == Backend.XLA:
            raise ValueError(
                "the XLA backend belongs to the JAX package; the port's "
                "collective groups run on backend='nccl' (CUDA devices) or "
                "backend='gloo' (host memory)")
        raise ValueError(f"unknown collective backend {name!r}")


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MAX = "max"
    MIN = "min"


@dataclass
class GroupInfo:
    group_name: str
    world_size: int
    rank: int
    backend: str
