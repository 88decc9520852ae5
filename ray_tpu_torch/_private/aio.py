"""Asyncio helpers.

`spawn` exists because the event loop keeps only WEAK references to tasks: a
fire-and-forget `asyncio.ensure_future(...)` can be garbage-collected mid-
flight, silently killing in-flight RPC work. Every background task in the
framework goes through `spawn`, which pins the task in a strong set until it
completes (and logs unexpected exceptions instead of swallowing them).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional, Set

logger = logging.getLogger(__name__)

_BACKGROUND: Set[asyncio.Task] = set()


def spawn(coro: Coroutine, name: Optional[str] = None) -> asyncio.Task:
    task = asyncio.ensure_future(coro)
    if name:
        task.set_name(name)
    _BACKGROUND.add(task)
    task.add_done_callback(_done)
    return task


def _done(task: asyncio.Task) -> None:
    _BACKGROUND.discard(task)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.error("background task %s failed: %r", task.get_name(), exc)
