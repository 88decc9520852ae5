"""multiprocessing.Pool API over ray_tpu_torch actors.

Reference surface: python/ray/util/multiprocessing/pool.py — a drop-in
`Pool` whose workers are cluster actors, so `pool.map` scales past one host.
Original implementation over ray_tpu_torch actors and futures.
"""

from __future__ import annotations

import itertools
import multiprocessing as _stdlib_mp
import os
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class TimeoutError(_stdlib_mp.TimeoutError):  # noqa: A001 — drop-in parity
    """Matches multiprocessing.TimeoutError so existing except clauses
    written against the stdlib Pool keep catching it."""


class AsyncResult:
    """multiprocessing.pool.AsyncResult over ObjectRefs."""

    def __init__(self, refs: List[Any], single: bool, callback=None,
                 error_callback=None):
        self._refs = refs
        self._single = single
        self._callback = callback
        self._error_callback = error_callback
        self._result = None
        self._error: Optional[BaseException] = None
        self._done = False

    def _finish(self, timeout=None):
        if self._done:
            return
        try:
            values = ray_tpu_torch.get(self._refs, timeout=timeout)
            out: List[Any] = []
            for v in values:
                out.extend(v)
            self._result = out[0] if self._single else out
            self._done = True
            if self._callback is not None:
                self._callback(self._result)
        except ray_tpu_torch.GetTimeoutError:
            raise TimeoutError("result not ready within timeout") from None
        except BaseException as e:  # noqa: BLE001 — user function error
            self._error = e
            self._done = True
            if self._error_callback is not None:
                self._error_callback(e)

    def get(self, timeout: Optional[float] = None):
        self._finish(timeout)
        if self._error is not None:
            raise self._error
        return self._result

    def wait(self, timeout: Optional[float] = None):
        try:
            ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                         timeout=timeout)
        except Exception:  # noqa: BLE001
            pass

    def ready(self) -> bool:
        if self._done:
            return True
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self._done:
            raise ValueError("result is not ready")
        return self._error is None


@ray_tpu_torch.remote
class _PoolWorker:
    """One pool process (reference: multiprocessing pool worker actor)."""

    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run_chunk(self, fn, chunk, star: bool):
        if star:
            return [fn(*item) for item in chunk]
        return [fn(item) for item in chunk]


class Pool:
    """Drop-in multiprocessing.Pool running on cluster actors."""

    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), ray_address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=ray_address)
        if processes is None:
            cpus = ray_tpu_torch.cluster_resources().get("CPU", os.cpu_count() or 1)
            processes = max(1, int(cpus))
        self._actors = [
            _PoolWorker.remote(initializer, initargs) for _ in range(processes)
        ]
        self._processes = processes
        self._rr = itertools.cycle(range(processes))
        self._closed = False

    # -- submission ----------------------------------------------------

    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunked(self, iterable, chunksize: Optional[int]) -> List[list]:
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize] for i in range(0, len(items), chunksize)]

    def _submit_chunks(self, fn, chunks: List[list], star: bool) -> List[Any]:
        return [
            self._actors[next(self._rr)].run_chunk.remote(fn, chunk, star)
            for chunk in chunks
        ]

    def apply(self, fn: Callable, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args=(), kwds=None, callback=None,
                    error_callback=None) -> AsyncResult:
        self._check_running()
        kwds = kwds or {}
        actor = self._actors[next(self._rr)]
        ref = actor.run_chunk.remote(
            lambda a: fn(*a[0], **a[1]), [(args, kwds)], False
        )
        return AsyncResult([ref], single=True, callback=callback,
                           error_callback=error_callback)

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> list:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None, callback=None,
                  error_callback=None) -> AsyncResult:
        self._check_running()
        refs = self._submit_chunks(fn, self._chunked(iterable, chunksize),
                                   star=False)
        return AsyncResult(refs, single=False, callback=callback,
                           error_callback=error_callback)

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> list:
        self._check_running()
        refs = self._submit_chunks(fn, self._chunked(iterable, chunksize),
                                   star=True)
        return AsyncResult(refs, single=False).get()

    def starmap_async(self, fn: Callable, iterable: Iterable,
                      chunksize: Optional[int] = None) -> AsyncResult:
        self._check_running()
        refs = self._submit_chunks(fn, self._chunked(iterable, chunksize),
                                   star=True)
        return AsyncResult(refs, single=False)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int = 1):
        self._check_running()
        refs = self._submit_chunks(fn, self._chunked(iterable, chunksize),
                                   star=False)
        for ref in refs:  # submission order
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int = 1):
        self._check_running()
        refs = self._submit_chunks(fn, self._chunked(iterable, chunksize),
                                   star=False)
        pending = list(refs)
        while pending:
            # wait may report more than num_returns refs ready at once;
            # consume every one or completed chunks are silently dropped
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for r in ready:
                yield from ray_tpu_torch.get(r)

    # -- lifecycle -----------------------------------------------------

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass
        self._actors = []

    def join(self):
        """No outstanding-work tracking beyond AsyncResults: consumers hold
        their own results, and terminate()/handle GC reap the actors — so
        join only validates the close-before-join contract."""
        if not self._closed:
            raise ValueError("Pool is still running — call close() first")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc):
        self.terminate()


__all__ = ["Pool", "AsyncResult", "TimeoutError"]
