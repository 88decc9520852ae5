"""Collective operations inside compiled DAGs.

Reference surface: python/ray/dag/collective_node.py:23 (_CollectiveOperation,
CollectiveOutputNode :252) — NCCL allreduce between actor DAG nodes.

The JAX package's redesign, copied: device-resident tensors reduce with
the framework's collectives INSIDE a step (torch.distributed here, or a
collective group of ``ray_tpu_torch.util.collective``); the graph-plane
collective here serves HOST values (numpy grads/metrics between pipeline
stage actors) and rides the same preallocated shm channel plane as
every other compiled edge — participant i streams its contribution to the
root participant, the root reduces and streams the result back. No task
submission, no driver round-trip.

    o1 = a1.grads.bind(inp)
    o2 = a2.grads.bind(inp)
    r1, r2 = allreduce.bind([o1, o2], op="sum")
    dag = MultiOutputNode([a1.apply.bind(r1), a2.apply.bind(r2)])
"""

from __future__ import annotations

from typing import List

from ray_tpu_torch.dag import ClassMethodNode, DAGNode


class _CollectiveOperation:
    def __init__(self, nodes: List[ClassMethodNode], op: str = "sum"):
        if len(nodes) < 2:
            raise ValueError("a collective needs at least 2 participants")
        for n in nodes:
            if not isinstance(n, ClassMethodNode):
                raise TypeError(
                    "collective participants must be actor-method nodes")
        self.nodes = list(nodes)
        self.op = op
        self.outputs = [CollectiveOutputNode(self, i)
                        for i in range(len(nodes))]


class CollectiveOutputNode(DAGNode):
    """Participant i's view of the reduced value (reference:
    collective_node.py:252). Lives on the same actor as operation.nodes[i]."""

    def __init__(self, operation: _CollectiveOperation, index: int):
        self.operation = operation
        self.index = index


class allreduce:  # noqa: N801 — mirrors the reference's binding surface
    @staticmethod
    def bind(nodes: List[ClassMethodNode], op: str = "sum") \
            -> List[CollectiveOutputNode]:
        return _CollectiveOperation(nodes, op).outputs


__all__ = ["CollectiveOutputNode", "allreduce"]
