"""Model multiplexing: many models share one replica pool.

Reference: python/ray/serve/multiplex.py (@serve.multiplexed LRU model
loader + serve.get_multiplexed_model_id) and the multiplex-aware router
preference in request_router/pow_2_router.py — requests for a model prefer
replicas that already have it loaded.
"""

from __future__ import annotations

import contextvars
import functools
import inspect
from collections import OrderedDict
from typing import Callable, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rt_serve_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """Model id of the in-flight request (reference:
    serve.get_multiplexed_model_id)."""
    return _current_model_id.get()


def _set_model_id(model_id: str):
    return _current_model_id.set(model_id)


def multiplexed(_fn: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorate an async `get_model(self, model_id)` loader: results are
    LRU-cached per replica up to max_num_models_per_replica; eviction drops
    the least-recently-used model (its __del__ releases resources)."""

    def decorate(fn: Callable):
        @functools.wraps(fn)
        async def wrapper(self, model_id: str):
            cache: "OrderedDict" = getattr(self, "_rt_model_cache", None)
            if cache is None:
                cache = OrderedDict()
                self._rt_model_cache = cache
                self._rt_model_loading = {}
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            loading = self._rt_model_loading.get(model_id)
            if loading is not None:
                return await loading  # dedup concurrent loads of one model
            import asyncio

            fut = asyncio.get_running_loop().create_future()
            self._rt_model_loading[model_id] = fut
            try:
                out = fn(self, model_id)
                if inspect.isawaitable(out):
                    out = await out
                cache[model_id] = out
                cache.move_to_end(model_id)
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)  # evict LRU
                fut.set_result(out)
                return out
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
                raise
            finally:
                self._rt_model_loading.pop(model_id, None)

        wrapper._rt_multiplexed = True
        return wrapper

    if _fn is not None:
        return decorate(_fn)
    return decorate
