"""Distributed FIFO queue backed by an actor.

Reference surface: python/ray/util/queue.py (Queue with put/get/
put_nowait/get_nowait/qsize/empty/full, Empty/Full exceptions). The queue
lives in an async actor so blocking put/get suspend on the actor's event
loop without holding a thread.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self._q: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return True, await self._q.get()
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def put_nowait(self, item: Any) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def put_nowait_batch(self, items: List[Any]) -> int:
        n = 0
        for item in items:
            try:
                self._q.put_nowait(item)
                n += 1
            except asyncio.QueueFull:
                break
        return n

    async def get_nowait_batch(self, max_items: int) -> List[Any]:
        out = []
        while len(out) < max_items:
            try:
                out.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    async def qsize(self) -> int:
        return self._q.qsize()

    async def maxsize(self) -> int:
        return self._q.maxsize


class Queue:
    """Client facade; safe to pass between tasks/actors (reference:
    util/queue.py Queue — the handle serializes, the state stays in the
    actor)."""

    def __init__(self, maxsize: int = 0, *, _actor=None):
        self.maxsize = maxsize
        self._actor = _actor or _QueueActor.options(
            max_concurrency=64).remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None):
        if not block:
            return self.put_nowait(item)
        ok = ray_tpu_torch.get(
            self._actor.put.remote(item, timeout),
            timeout=None if timeout is None else timeout + 30,
        )
        if not ok:
            raise Full("queue full")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            return self.get_nowait()
        ok, item = ray_tpu_torch.get(
            self._actor.get.remote(timeout),
            timeout=None if timeout is None else timeout + 30,
        )
        if not ok:
            raise Empty("queue empty")
        return item

    def put_nowait(self, item: Any):
        if not ray_tpu_torch.get(self._actor.put_nowait.remote(item), timeout=30):
            raise Full("queue full")

    def get_nowait(self) -> Any:
        ok, item = ray_tpu_torch.get(self._actor.get_nowait.remote(), timeout=30)
        if not ok:
            raise Empty("queue empty")
        return item

    def put_nowait_batch(self, items: List[Any]):
        n = ray_tpu_torch.get(
            self._actor.put_nowait_batch.remote(list(items)), timeout=30)
        if n < len(items):
            raise Full(f"queue full after {n} items")

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return ray_tpu_torch.get(
            self._actor.get_nowait_batch.remote(num_items), timeout=30)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self):
        ray_tpu_torch.kill(self._actor)

    def __reduce__(self):
        # rebuild with the SAME actor — the naive (Queue, (maxsize,)) path
        # would spawn a fresh, empty queue actor per deserialization
        return (_rebuild_queue, (self.maxsize, self._actor))


def _rebuild_queue(maxsize: int, actor) -> "Queue":
    return Queue(maxsize, _actor=actor)
