"""Chunked object transfer shared by every RPC pull path.

Reference: src/ray/object_manager/push_manager.h chunking + pull assembly —
one implementation serves both the daemon↔daemon pull (node_daemon._do_pull)
and the remote-client read (core_worker._remote_read), so transfer fixes
(concurrency, retries, deadline handling) land in one place.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional


async def fetch_chunks(
    call: Callable,
    object_id: bytes,
    size: int,
    buf,
    *,
    chunk_bytes: int,
    concurrency: int = 8,
    timeout_for: Optional[Callable[[float], float]] = None,
    missing_error: Callable[[], BaseException] = lambda: RuntimeError(
        "object vanished mid-pull"
    ),
) -> None:
    """Fill `buf` (writable buffer of `size` bytes) with the object's data by
    issuing parallel `fetch_chunk` RPCs through `call(method, payload,
    timeout=...)`. `timeout_for(default)` maps a per-RPC default timeout to a
    deadline-aware one (raising when the deadline passed); `missing_error`
    builds the exception for a chunk whose object disappeared mid-read."""
    sem = asyncio.Semaphore(concurrency)

    async def fetch(off: int):
        async with sem:
            r = await call("fetch_chunk", {
                "object_id": object_id, "offset": off,
                "length": min(chunk_bytes, size - off),
            }, timeout=timeout_for(60) if timeout_for else 60)
            if not r.get("found"):
                raise missing_error()
            buf[off:off + len(r["data"])] = r["data"]

    await asyncio.gather(*[fetch(o) for o in range(0, size, chunk_bytes)])
