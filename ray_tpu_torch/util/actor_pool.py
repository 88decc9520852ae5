"""ActorPool: load-balance tasks over a fixed set of actors.

Reference surface: python/ray/util/actor_pool.py (ActorPool.map/map_unordered/
submit/get_next/get_next_unordered/has_next/push/pop_idle). Original
implementation over ray_tpu_torch futures.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor: dict = {}
        self._pending: List[Any] = []  # refs in submission order
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def submit(self, fn: Callable[[Any, Any], Any], value: Any):
        """fn(actor, value) -> ObjectRef; runs when an actor is free."""
        if not self._idle:
            raise RuntimeError("no idle actors — call get_next() first")
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1
        self._pending.append(ref)

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def has_free(self) -> bool:
        return bool(self._idle)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in submission order. A timeout leaves the pool state
        untouched so the same result can be fetched again (reference:
        ActorPool.get_next re-raisable TimeoutError)."""
        from ray_tpu_torch._private.errors import GetTimeoutError

        if self._next_return_index >= self._next_task_index:
            raise StopIteration("no pending results")
        ref = self._index_to_future[self._next_return_index]
        try:
            value = ray_tpu_torch.get(ref, timeout=timeout)
        except GetTimeoutError:
            raise  # task still running: actor stays busy, result retrievable
        except BaseException:
            # the task failed — the actor itself is free again
            del self._index_to_future[self._next_return_index]
            self._next_return_index += 1
            self._release(ref)
            raise
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._release(ref)
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next result in completion order."""
        if not self._pending:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(self._pending, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        self._pending.remove(ref)
        for idx, f in list(self._index_to_future.items()):
            if f is ref:
                del self._index_to_future[idx]
        try:
            return ray_tpu_torch.get(ref, timeout=timeout)
        finally:
            self._release(ref)

    def _release(self, ref):
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None:
            self._idle.append(actor)
        if ref in self._pending:
            self._pending.remove(ref)

    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        """Ordered results; keeps every actor busy (reference: map)."""
        values = list(values)
        submitted = 0
        for v in values:
            if not self._idle:
                break
            self.submit(fn, v)
            submitted += 1
        for i in range(len(values)):
            yield self.get_next()
            if submitted < len(values):
                self.submit(fn, values[submitted])
                submitted += 1

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]):
        values = list(values)
        submitted = 0
        for v in values:
            if not self._idle:
                break
            self.submit(fn, v)
            submitted += 1
        for _ in range(len(values)):
            yield self.get_next_unordered()
            if submitted < len(values):
                self.submit(fn, values[submitted])
                submitted += 1

    def push(self, actor: Any):
        self._idle.append(actor)

    def pop_idle(self) -> Any:
        if not self._idle:
            return None
        return self._idle.pop()
