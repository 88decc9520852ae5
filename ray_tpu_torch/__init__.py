"""ray_tpu_torch — the PyTorch / CUDA port of ray_tpu.

Mirrors the module paths of ``ray_tpu`` and imports nothing of it and
nothing of JAX. The compute layer (``ops/``, ``models/``, ``parallel/``,
``llm/``, ``train/``, ``rllib/``) runs on CUDA unless the caller passes
``device="cpu"``; every kernel that ``ray_tpu`` wrote in Pallas for the TPU
is a hand-written CUDA kernel under ``csrc/``. The runtime (``_private/``,
``runtime/``, ``native/``: tasks, actors, objects) is the JAX package's,
with CUDA devices as the ``"GPU"`` resource in place of TPU chips
(``gpu/accelerator.py``). ``import ray_tpu_torch`` and the runtime's
processes import no torch: torch is imported where a tensor is handled.
"""

from ray_tpu_torch._private.core_worker import (
    ObjectRef,
    ObjectRefGenerator,
    get_core_worker,
)
from ray_tpu_torch._private.errors import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    ObjectStoreFullError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch._private.worker import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    shutdown,
    wait,
)


def remote(*args, **kwargs):
    """`@ray_tpu_torch.remote` decorator for functions and actor classes.

    Reference: python/ray/remote_function.py:347 and python/ray/actor.py:1545.
    """
    import inspect

    from ray_tpu_torch.actor import ActorClass
    from ray_tpu_torch.remote_function import RemoteFunction

    def decorate(target, options=None):
        if inspect.isclass(target):
            return ActorClass(target, options)
        if not callable(target):
            raise TypeError("@remote requires a function or class")
        return RemoteFunction(target, options)

    if len(args) == 1 and not kwargs and (inspect.isclass(args[0]) or callable(args[0])):
        return decorate(args[0])
    if args:
        raise TypeError("@remote() accepts only keyword options")

    def wrapper(target):
        return decorate(target, kwargs)

    return wrapper


def method(**opts):
    """Per-actor-method options (reference: ray.method) — e.g.
    ``@ray_tpu_torch.method(concurrency_group="io", num_returns=2)``."""
    from ray_tpu_torch.actor import method as _method

    return _method(**opts)


__version__ = "0.1.0"

__all__ = [
    "ObjectRef",
    "ObjectRefGenerator",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "method",
    "get",
    "put",
    "wait",
    "cancel",
    "kill",
    "TaskCancelledError",
    "get_actor",
    "nodes",
    "cluster_resources",
    "available_resources",
    "get_core_worker",
    "RayTpuError",
    "TaskError",
    "ActorDiedError",
    "ActorUnavailableError",
    "WorkerCrashedError",
    "ObjectLostError",
    "ObjectStoreFullError",
    "GetTimeoutError",
    "__version__",
]
