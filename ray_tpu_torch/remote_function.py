"""@ray_tpu_torch.remote functions.

Capability parity with the reference's remote function surface (reference:
python/ray/remote_function.py:347 RemoteFunction._remote and the options
system of python/ray/_private/ray_option_utils.py): `.remote()` exports the
function once through the control-store KV and submits tasks; `.options()`
returns a shallow override copy.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch._private.core_worker import get_core_worker
from ray_tpu_torch._private.protocol import (
    STRATEGY_NODE_AFFINITY,
    STRATEGY_PLACEMENT_GROUP,
    STRATEGY_SPREAD,
    SchedulingStrategy,
)

_VALID_OPTIONS = {
    "num_cpus", "num_gpus", "resources", "num_returns", "max_retries",
    "retry_exceptions", "scheduling_strategy", "name", "label_selector",
    "placement_group", "placement_group_bundle_index", "runtime_env",
    "_generator_backpressure_num_objects",
}


def build_strategy(opts: Dict[str, Any]) -> SchedulingStrategy:
    strategy = opts.get("scheduling_strategy")
    if isinstance(strategy, SchedulingStrategy):
        s = strategy
    elif strategy == "SPREAD":
        s = SchedulingStrategy(kind=STRATEGY_SPREAD)
    elif isinstance(strategy, str) and strategy.startswith("node:"):
        s = SchedulingStrategy(kind=STRATEGY_NODE_AFFINITY, node_id=strategy[5:])
    else:
        s = SchedulingStrategy()
    pg = opts.get("placement_group")
    if pg is not None:
        pg_id = pg.id.hex() if hasattr(pg, "id") else str(pg)
        s = SchedulingStrategy(
            kind=STRATEGY_PLACEMENT_GROUP,
            placement_group_id=pg_id,
            bundle_index=opts.get("placement_group_bundle_index", -1),
        )
    if opts.get("label_selector"):
        s.label_selector = dict(opts["label_selector"])
    return s


def build_resources(opts: Dict[str, Any], default_cpu: float = 1.0) -> Dict[str, float]:
    res = dict(opts.get("resources") or {})
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    if "num_cpus" in opts and opts["num_cpus"] is not None:
        res["CPU"] = float(opts["num_cpus"])
    elif "CPU" not in res and not (res and opts.get("placement_group")):
        # the implicit 1-CPU scheduling default does NOT apply to a
        # placement-group request that already names custom resources
        # (including one expressed via num_gpus — GPU is folded in above
        # so it counts): the PG bundle is the resource envelope, and
        # silently adding CPU to a bundle that never reserved any makes
        # the request permanently unplaceable (it used to retry forever,
        # invisibly)
        res["CPU"] = default_cpu
    return res


def _value_digest(value) -> bytes:
    """Stable bytes for hashing a captured value into a function key."""
    try:
        return cloudpickle.dumps(value)
    except Exception:  # noqa: BLE001 — unpicklable capture: fall back
        return repr(value).encode()


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        for k in self._options:
            if k not in _VALID_OPTIONS:
                raise ValueError(f"invalid @remote option {k!r}")
        code = getattr(fn, "__code__", None)
        h = hashlib.blake2b(digest_size=8)
        h.update(fn.__module__.encode() if fn.__module__ else b"")
        h.update(fn.__qualname__.encode())
        if code is not None:
            h.update(code.co_code)
        # closure cells and defaults are part of the function's behavior:
        # two closures over the same code but different captured values must
        # not collide on one exported definition (the export is cached by
        # key cluster-wide)
        for cell in getattr(fn, "__closure__", None) or ():
            h.update(_value_digest(cell.cell_contents))
        for default in getattr(fn, "__defaults__", None) or ():
            h.update(_value_digest(default))
        self._function_key = f"{fn.__qualname__}:{h.hexdigest()}"
        self._exported = False

    @property
    def _function_name(self) -> str:
        return self._fn.__qualname__

    def options(self, **overrides) -> "RemoteFunction":
        merged = {**self._options, **overrides}
        clone = RemoteFunction.__new__(RemoteFunction)
        clone._fn = self._fn
        clone._options = merged
        for k in overrides:
            if k not in _VALID_OPTIONS:
                raise ValueError(f"invalid options() key {k!r}")
        clone._function_key = self._function_key
        clone._exported = self._exported
        return clone

    def bind(self, *args, **kwargs):
        """Build a DAG node instead of executing (reference:
        remote_function bind — the ray.dag authoring surface)."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def remote(self, *args, **kwargs):
        cw = get_core_worker()
        cached = self.__dict__.get("_submit_cache")
        if cached is None:
            cached = self._build_submit_cache()
        streaming, num_returns, call_opts = cached

        # Non-blocking from every calling context (reference: .remote() never
        # waits on the data plane): args serialize on this thread so
        # serialization errors raise at the call site; the lease/push
        # pipeline continues on the loop.
        result = cw.submit_task_fast(
            self._fn, self._function_key, args, kwargs, **call_opts
        )
        if streaming or num_returns == 1:
            return result[0] if not streaming else result
        return result

    def _build_submit_cache(self):
        """Options are constant per RemoteFunction — resolve them (and the
        ResourceSet / strategy / lease key) once, not on every .remote()."""
        from ray_tpu_torch._private.core_worker import compute_lease_key
        from ray_tpu_torch._private.protocol import NUM_RETURNS_STREAMING, ResourceSet

        opts = self._options
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        resources = ResourceSet(build_resources(opts))
        strategy = build_strategy(opts)
        call_opts = dict(
            num_returns=NUM_RETURNS_STREAMING if streaming else num_returns,
            resources=resources,
            strategy=strategy,
            max_retries=opts.get("max_retries"),
            name=self._function_name,
            runtime_env=opts.get("runtime_env"),
            stream_backpressure=opts.get("_generator_backpressure_num_objects", -1),
            lease_key=compute_lease_key(resources, strategy),
        )
        cached = (streaming, num_returns, call_opts)
        self._submit_cache = cached
        return cached

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._function_name} cannot be called directly; "
            f"use .remote()"
        )
