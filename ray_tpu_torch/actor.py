"""@ray_tpu_torch.remote actor classes.

Capability parity with the reference's actor surface (reference:
python/ray/actor.py:1545 ActorClass, :1875 ActorClass._remote, :2266
ActorHandle, :848 ActorMethod): `.remote()` registers the actor with the
control store which schedules and instantiates it on a node; handles submit
ordered method tasks directly to the actor's worker; handles pickle by actor
id and rebind through the control store on the receiving side.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

from ray_tpu_torch._private.core_worker import get_core_worker
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch.remote_function import build_resources, build_strategy

_VALID_ACTOR_OPTIONS = {
    "num_cpus", "num_gpus", "resources", "max_restarts", "max_task_retries",
    "max_concurrency", "name", "namespace", "lifetime", "scheduling_strategy",
    "label_selector", "placement_group", "placement_group_bundle_index",
    "runtime_env", "concurrency_groups", "drain_cooperative",
}

_VALID_METHOD_OPTIONS = {"num_returns", "concurrency_group"}


def method(**opts):
    """Per-method options decorator (reference: ray.method, actor.py:848) —
    ``@ray_tpu_torch.method(concurrency_group="io", num_returns=2)``."""
    for k in opts:
        if k not in _VALID_METHOD_OPTIONS:
            raise ValueError(f"invalid @method option {k!r}")

    def decorate(fn):
        fn.__rt_method_opts__ = dict(opts)
        return fn

    return decorate


class ActorMethod:
    __slots__ = ("_handle", "_method_name", "_num_returns", "_concurrency_group")

    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1, concurrency_group: str = ""):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        return self._handle._submit(
            self._method_name, args, kwargs, num_returns=self._num_returns,
            concurrency_group=self._concurrency_group,
        )

    def options(self, num_returns: Optional[int] = None,
                concurrency_group: Optional[str] = None) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._method_name,
            self._num_returns if num_returns is None else num_returns,
            self._concurrency_group if concurrency_group is None
            else concurrency_group,
        )

    def bind(self, *args, **kwargs):
        """Build a DAG node instead of executing (reference: actor.py bind —
        the ray.dag authoring surface)."""
        from ray_tpu_torch.dag import ClassMethodNode

        return ClassMethodNode(self._handle, self._method_name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name} cannot be called directly; use .remote()"
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_key: str, method_meta: Optional[dict],
                 max_task_retries: int = 0, concurrent: bool = False,
                 _owned: bool = False):
        self._actor_id = actor_id
        self._class_key = class_key
        self._method_meta = method_meta or {}
        self._max_task_retries = max_task_retries
        # async/threaded/concurrency-group actor: executions overlap, so
        # pushes bypass reply batching (see CoreWorker._actor_push)
        self._concurrent = concurrent
        self._owned = _owned
        if _owned:
            cw = get_core_worker()
            cw.add_actor_handle_ref(actor_id.binary())
            # Pin the session that holds the refcount, by its worker id: a
            # handle GC'd late (cycle collector) after shutdown()+init()
            # must not decrement a colliding actor id in the NEW session's
            # core worker. (Not by a weakref, as the JAX package does: the
            # cycle collector clears a weakref that garbage holds before
            # the finaliser runs, so the release never came and the actor
            # outlived its last handle.)
            self._owner_worker_id = cw.worker_id.binary()

    def __del__(self):
        if getattr(self, "_owned", False):
            try:
                cw = get_core_worker()
                if cw.worker_id.binary() == self._owner_worker_id:
                    cw.remove_actor_handle_ref_deferred(
                        self._actor_id.binary())
            except Exception:  # noqa: BLE001 — no session, or shutdown
                pass

    def _submit(self, method_name: str, args, kwargs, num_returns: int = 1,
                concurrency_group: str = ""):
        from ray_tpu_torch._private.protocol import NUM_RETURNS_STREAMING

        cw = get_core_worker()
        streaming = num_returns == "streaming"
        wire_returns = NUM_RETURNS_STREAMING if streaming else num_returns
        # non-blocking from every context: seq assignment happens on the
        # calling thread (ordering decided here), serialization + delivery
        # continue on the event loop. A per-call blocking loop hop would
        # cap pipelined submission at the thread-handoff rate.
        result = cw.submit_actor_task_nowait(
            self._actor_id.binary(), method_name, args, kwargs,
            num_returns=wire_returns,
            max_task_retries=self._max_task_retries,
            concurrency_group=concurrency_group,
            concurrent=self._concurrent,
        )
        if streaming:
            return result
        return result[0] if num_returns == 1 else result

    def __getattr__(self, name: str):
        if name.startswith("_") and name != "__rt_call__":
            raise AttributeError(name)
        meta = self._method_meta.get(name)
        if isinstance(meta, int):  # legacy form: bare num_returns
            meta = {"num_returns": meta}
        meta = meta or {}
        return ActorMethod(
            self, name, meta.get("num_returns", 1),
            meta.get("concurrency_group", ""),
        )

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:16]})"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._class_key, self._method_meta,
             self._max_task_retries, self._concurrent),
        )

    def _actor_info(self) -> dict:
        cw = get_core_worker()
        return cw.run_sync(
            cw.control.call("get_actor_info", {"actor_id": self._actor_id.binary()})
        )["actor"]


class ActorClass:
    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        for k in self._options:
            if k not in _VALID_ACTOR_OPTIONS:
                raise ValueError(f"invalid actor @remote option {k!r}")
        h = hashlib.blake2b(digest_size=8)
        h.update(cls.__module__.encode() if cls.__module__ else b"")
        h.update(cls.__qualname__.encode())
        for attr in sorted(vars(cls)):
            fn = vars(cls)[attr]
            if callable(fn) and hasattr(fn, "__code__"):
                h.update(fn.__code__.co_code)
        self._class_key = f"actor:{cls.__qualname__}:{h.hexdigest()}"

    def options(self, **overrides) -> "ActorClass":
        for k in overrides:
            if k not in _VALID_ACTOR_OPTIONS:
                raise ValueError(f"invalid options() key {k!r}")
        clone = ActorClass.__new__(ActorClass)
        clone._cls = self._cls
        clone._options = {**self._options, **overrides}
        clone._class_key = self._class_key
        return clone

    def _method_meta(self) -> Dict[str, dict]:
        """Collect @ray_tpu_torch.method options declared on the class, walking
        the MRO so base-class declarations apply to subclass actors
        (subclass overrides win)."""
        meta: Dict[str, dict] = {}
        for klass in reversed(self._cls.__mro__):
            for attr, fn in vars(klass).items():
                mopts = getattr(fn, "__rt_method_opts__", None)
                if mopts:
                    meta[attr] = dict(mopts)
        return meta

    def remote(self, *args, **kwargs) -> ActorHandle:
        cw = get_core_worker()
        opts = self._options
        is_async = _is_async_actor(self._cls)
        resources = build_resources(opts)
        method_meta = self._method_meta()
        groups = dict(opts.get("concurrency_groups") or {})
        for mname, mopts in method_meta.items():
            g = mopts.get("concurrency_group")
            if g and g not in groups:
                raise ValueError(
                    f"method {mname!r} uses undeclared concurrency group {g!r}"
                    f" (declare it via concurrency_groups={{...}})"
                )

        async def create():
            await cw.export_function(self._class_key, self._cls)
            return await cw.create_actor(
                self._class_key,
                args,
                kwargs,
                resources=resources,
                max_restarts=opts.get("max_restarts", 0),
                max_task_retries=opts.get("max_task_retries", 0),
                max_concurrency=opts.get(
                    "max_concurrency", 1000 if is_async else 1
                ),
                is_async=is_async,
                strategy=build_strategy(opts),
                name=opts.get("name", ""),
                namespace=opts.get("namespace", ""),
                detached=opts.get("lifetime") == "detached",
                runtime_env=opts.get("runtime_env"),
                concurrency_groups=groups,
                method_meta=method_meta,
                drain_cooperative=opts.get("drain_cooperative", False),
            )

        if cw._loop_running_here():
            # inside an async actor: non-blocking creation
            actor_id = cw.create_actor_nowait(
                self._cls, self._class_key, args, kwargs,
                resources=resources,
                max_restarts=opts.get("max_restarts", 0),
                max_task_retries=opts.get("max_task_retries", 0),
                max_concurrency=opts.get("max_concurrency", 1000 if is_async else 1),
                is_async=is_async,
                strategy=build_strategy(opts),
                name=opts.get("name", ""),
                namespace=opts.get("namespace", ""),
                detached=opts.get("lifetime") == "detached",
                runtime_env=opts.get("runtime_env"),
                concurrency_groups=groups,
                method_meta=method_meta,
                drain_cooperative=opts.get("drain_cooperative", False),
            )
        else:
            actor_id = cw.run_sync(create())
        # Unnamed, non-detached actors are GC'd with the creator's last handle.
        owned = not opts.get("name") and opts.get("lifetime") != "detached"
        concurrent = bool(
            is_async or opts.get("max_concurrency", 0) > 1 or groups)
        return ActorHandle(
            actor_id, self._class_key, method_meta,
            max_task_retries=opts.get("max_task_retries", 0),
            concurrent=concurrent,
            _owned=owned,
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use .remote()"
        )


def _is_async_actor(cls: type) -> bool:
    import inspect

    for attr in dir(cls):
        if attr.startswith("__"):
            continue
        if inspect.iscoroutinefunction(getattr(cls, attr, None)):
            return True
    return False
