"""ray_tpu_torch.dag — lazy actor-method DAGs with a compiled repeat-execution path.

Reference surface: python/ray/dag/dag_node.py (DAGNode.execute :369,
experimental_compile :283), input_node.py (InputNode), output_node.py
(MultiOutputNode), compiled_dag_node.py:813 (CompiledDAG). Authoring:
`actor.method.bind(...)` composes nodes; `InputNode()` marks the runtime
argument; `dag.execute(x)` submits the whole graph with refs chained
between stages (stages pipeline through the actor plane).

Design note (the JAX package's, ``ray_tpu/dag``, copied): the reference's
compiled path exists to drive pipeline-parallel device work through
preallocated NCCL/shm channels. Here the data plane between stages is the
shared-memory object store (zero-copy intra-node) and stage overlap comes
from issuing every stage's task eagerly with chained refs — executions
pipeline across actors because each actor's ordered queue starts stage N of
call i while downstream actors still run call i-1. A CUDA tensor crosses it
host-staged; device-to-device movement belongs to torch.distributed inside
a sharded step and to the collective groups' ``DeviceChannel``
(``experimental/device_channel.py``), not to the graph plane.

Pipeline-parallel TRAINING has two dedicated implementations on top of
these primitives: ray_tpu_torch.parallel.pipeline (GPipe over the "pp"
mesh axis — point-to-point hand-off between ranks) and
ray_tpu_torch.train.pipeline_actors (stage actors + 1F1B through this actor/
object plane — the reference's compiled-DAG shape, for cross-process/
cross-failure-domain stages)."""

from __future__ import annotations

import itertools
from typing import Any, Dict, List

_node_seq = itertools.count()


class DAGNode:
    """Base: a recipe for one task submission.

    Nodes record their authoring order (`_created`): a compiled DAG executes
    each actor's steps in authoring order, which is how schedules like 1F1B
    are expressed — bind the ops in the per-actor order you want them to run
    (the reference generates per-actor schedules the same way,
    compiled_dag_node.py _build_execution_schedule)."""

    def __new__(cls, *a, **k):
        obj = super().__new__(cls)
        obj._created = next(_node_seq)
        return obj

    def execute(self, *args, **kwargs):
        """Submit the whole reachable graph once; returns ObjectRef(s)
        (reference: dag_node.py:369)."""
        return _execute_graph(self, args, kwargs)

    def experimental_compile(self, max_in_flight: int = 8,
                             slot_size: int = 1 << 20):
        """Freeze the topology for repeated pipelined execution through
        preallocated shm channels + per-actor executor loops (reference:
        dag_node.py:283 → compiled_dag_node.py:813). See dag/_compiled.py."""
        from ray_tpu_torch.dag._compiled import CompiledDAG as _RealCompiledDAG

        return _RealCompiledDAG(self, max_in_flight=max_in_flight,
                                slot_size=slot_size)

    # -- authoring sugar -------------------------------------------------

    def __iter__(self):
        raise TypeError("DAGNode is not iterable; wrap in MultiOutputNode")


class InputNode(DAGNode):
    """Placeholder for the runtime argument (reference: input_node.py:12).
    Usable as a context manager for parity with the reference's authoring
    style: `with InputNode() as inp: ...`. Attribute/item access projects a
    field of the runtime input — no instance state may shadow it."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        ref = InputAttributeNode(self, name)
        return ref

    def __getitem__(self, key):
        return InputAttributeNode(self, key)


class InputAttributeNode(DAGNode):
    """inp.x / inp[k] — projects a field of the runtime input (reference:
    input_node.py InputAttributeNode)."""

    def __init__(self, parent: InputNode, key):
        self.parent = parent
        self.key = key


class ClassMethodNode(DAGNode):
    """One bound actor-method call (reference: class_node.ClassMethodNode)."""

    def __init__(self, handle, method_name: str, args: tuple, kwargs: dict):
        self.handle = handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs


class FunctionNode(DAGNode):
    """A bound remote-function call (reference: function_node.py)."""

    def __init__(self, fn, args: tuple, kwargs: dict):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs


class MultiOutputNode(DAGNode):
    """Bundle several leaves into one execute() (reference: output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        self.outputs = list(outputs)


def _resolve(node: Any, memo: Dict[int, Any], input_value: Any):
    """Post-order submission: returns the value to pass to consumers
    (ObjectRef for task nodes — the runtime chains them without the driver
    touching the data)."""
    if isinstance(node, InputNode):
        return input_value
    if isinstance(node, InputAttributeNode):
        if isinstance(input_value, dict):
            return input_value[node.key]
        return getattr(input_value, node.key)
    if not isinstance(node, DAGNode):
        return node
    key = id(node)
    if key in memo:
        return memo[key]
    if isinstance(node, MultiOutputNode):
        value = [_resolve(o, memo, input_value) for o in node.outputs]
    elif isinstance(node, ClassMethodNode):
        args = [_resolve(a, memo, input_value) for a in node.args]
        kwargs = {k: _resolve(v, memo, input_value)
                  for k, v in node.kwargs.items()}
        method = getattr(node.handle, node.method_name)
        value = method.remote(*args, **kwargs)
    elif isinstance(node, FunctionNode):
        args = [_resolve(a, memo, input_value) for a in node.args]
        kwargs = {k: _resolve(v, memo, input_value)
                  for k, v in node.kwargs.items()}
        value = node.fn.remote(*args, **kwargs)
    else:  # pragma: no cover
        raise TypeError(f"unknown DAG node {type(node)}")
    memo[key] = value
    return value


def _execute_graph(root: DAGNode, args: tuple, kwargs: dict):
    if kwargs:
        input_value = dict(kwargs)
        if args:
            raise ValueError("pass the input positionally OR by keyword")
    else:
        input_value = args[0] if args else None
    memo: Dict[int, Any] = {}
    return _resolve(root, memo, input_value)


from ray_tpu_torch.dag._compiled import CompiledDAG, CompiledDAGRef  # noqa: E402

__all__ = [
    "ClassMethodNode",
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGNode",
    "FunctionNode",
    "InputNode",
    "InputAttributeNode",
    "MultiOutputNode",
]
