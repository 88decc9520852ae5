"""Local testing mode: run deployments in-process, no cluster.

Reference: python/ray/serve/_private/local_testing_mode.py — unit tests
construct the user callable directly and route handle calls to it, so a
deployment's logic is testable without a controller, replicas, or a
running ray_tpu_torch cluster. The handle mimics DeploymentHandle's surface
(`.remote(...).result()`, `.method(name)`, `.options(stream=True)`).
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Optional


class _LocalResponse:
    def __init__(self, value: Any = None, error: Optional[Exception] = None):
        self._value = value
        self._error = error

    def result(self, timeout: Optional[float] = None):
        if self._error is not None:
            raise self._error
        return self._value


class _LocalStream:
    def __init__(self, gen):
        self._gen = gen

    def __iter__(self):
        for item in self._gen:
            yield _LocalResponse(item)

    def __aiter__(self):
        async def agen():
            for item in self._gen:
                yield _AwaitableItem(item)

        return agen()


class _AwaitableItem:
    def __init__(self, item):
        self._item = item

    def __await__(self):
        async def get():
            return self._item

        return get().__await__()


class LocalHandle:
    """In-process stand-in for DeploymentHandle."""

    def __init__(self, instance, method_name: str = "__call__",
                 stream: bool = False):
        self._instance = instance
        self._method_name = method_name
        self._stream = stream

    def method(self, name: str) -> "LocalHandle":
        return LocalHandle(self._instance, name, self._stream)

    def options(self, *, stream: Optional[bool] = None,
                **_ignored) -> "LocalHandle":
        # merge semantics like the real DeploymentHandle: unset fields keep
        # the handle's current values across chained options() calls
        return LocalHandle(
            self._instance, self._method_name,
            self._stream if stream is None else stream)

    def remote(self, *args, **kwargs):
        target = getattr(self._instance, self._method_name, None)
        if target is None and callable(self._instance) \
                and self._method_name == "__call__":
            target = self._instance
        if target is None:
            return _LocalResponse(error=AttributeError(
                f"deployment has no method {self._method_name!r}"))
        try:
            out = target(*args, **kwargs)
            if inspect.iscoroutine(out):
                # asyncio.run in a helper thread works whether or not the
                # caller already has a running loop (get_event_loop() with
                # no current loop is deprecated/removed)
                out = _sync_await(out)
            if inspect.isasyncgen(out):
                out = _drain_asyncgen(out)
            if self._stream:
                if inspect.isgenerator(out) or isinstance(out, list):
                    return _LocalStream(iter(out)
                                        if isinstance(out, list) else out)
                return _LocalStream(iter([out]))
            return _LocalResponse(out)
        except Exception as e:  # noqa: BLE001 — surfaces at .result()
            return _LocalResponse(error=e)


def _sync_await(coro):
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(asyncio.run, coro).result()


def _drain_asyncgen(agen) -> list:
    async def collect():
        return [item async for item in agen]

    return _sync_await(collect())


def run_local(dep) -> LocalHandle:
    """Build a deployment's callable in-process and return a LocalHandle
    (reference: serve.run(..., _local_testing_mode=True))."""
    target = dep._target
    if inspect.isclass(target):
        instance = target(*dep._init_args, **dep._init_kwargs)
    else:
        if dep._init_args or dep._init_kwargs:
            raise ValueError("function deployments take no init args")
        instance = target
    return LocalHandle(instance)


__all__ = ["LocalHandle", "run_local"]
