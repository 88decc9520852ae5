"""Preallocated shared-memory channels — the compiled-graph data plane.

Reference surface: python/ray/experimental/channel/shared_memory_channel.py
(mutable-plasma channels preallocated per compiled-DAG edge) +
experimental_mutable_object_manager.h. Redesign: a channel is ONE sealed
object in the node's serverless shm store holding a native SPSC ring
(ray_tpu_torch/native/shm_channel.cc); producer and consumer map the same segment
and synchronize through C++ atomics — a hop costs one serialize + memcpy +
atomic publish, with no RPC, task submission, scheduling, or allocation.

Ring capacity doubles as pipeline backpressure: `write` blocks when the
consumer is `nslots` executions behind, exactly how the reference bounds
in-flight compiled-DAG executions via its channel buffers.

Blocking reads/writes park on a futex doorbell in the shared header
(rt_chan_wait_readable / rt_chan_wait_writable) — no sleep-polling, so an
idle compiled-DAG executor loop costs zero CPU and a hop wakes at kernel
futex latency instead of a poll interval (the reference's channels block on
OS primitives the same way). Waits are chunked so Python signal handlers
(Ctrl-C) still run between kernel sleeps.
"""

from __future__ import annotations

import ctypes
import time
from typing import Any, Optional

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.native.build import lib_path

# futex waits release the GIL but block signal delivery for their duration;
# cap each kernel sleep so KeyboardInterrupt lands within this bound
_WAIT_CHUNK_S = 0.5


class _Lib:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            lib = ctypes.CDLL(lib_path("shm_channel"))
            lib.rt_chan_required_size.restype = ctypes.c_uint64
            lib.rt_chan_required_size.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
            lib.rt_chan_init.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
            lib.rt_chan_validate.argtypes = [ctypes.c_void_p]
            lib.rt_chan_reserve.restype = ctypes.c_int64
            lib.rt_chan_reserve.argtypes = [ctypes.c_void_p]
            lib.rt_chan_commit.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.rt_chan_acquire.restype = ctypes.c_int64
            lib.rt_chan_acquire.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
            lib.rt_chan_release.argtypes = [ctypes.c_void_p]
            lib.rt_chan_close.argtypes = [ctypes.c_void_p]
            lib.rt_chan_readable.restype = ctypes.c_uint64
            lib.rt_chan_readable.argtypes = [ctypes.c_void_p]
            lib.rt_chan_wait_readable.restype = ctypes.c_int
            lib.rt_chan_wait_readable.argtypes = [
                ctypes.c_void_p, ctypes.c_int64]
            lib.rt_chan_wait_writable.restype = ctypes.c_int
            lib.rt_chan_wait_writable.argtypes = [
                ctypes.c_void_p, ctypes.c_int64]
            lib.rt_chan_prefault.argtypes = [ctypes.c_void_p, ctypes.c_int]
            cls._instance = lib
        return cls._instance


def channel_object_id(dag_id: str, edge: str) -> ObjectID:
    import hashlib

    digest = hashlib.sha256(f"rtchan:{dag_id}:{edge}".encode()).digest()
    return ObjectID(digest[:24])


class ShmChannel:
    """One compiled-DAG edge. Create once (creator=True), then open from any
    process on the node that shares the store.

    Channel state mutates after seal BY DESIGN — these are the framework's
    mutable objects (reference: experimental_mutable_object_manager.h); the
    seal only publishes the region. All mutation goes through the native
    SPSC ring ops against the store's writable mapping; the object stays
    pinned by this handle's get() refcount so the LRU can never evict a
    live channel."""

    def __init__(self, store, oid: ObjectID, *, creator: bool = False,
                 nslots: int = 8, slot_size: int = 1 << 20):
        self._lib = _Lib()
        self._lib.rt_chan_slot_size.restype = ctypes.c_uint64
        self._lib.rt_chan_slot_size.argtypes = [ctypes.c_void_p]
        self._store = store
        self.oid = oid
        size = self._lib.rt_chan_required_size(nslots, slot_size)
        if creator:
            view = store.create(oid, size)
            # the ring header must be valid BEFORE seal publishes the
            # object: a peer's open (get_blocking) returns the instant the
            # seal lands, and an uninitialized header fails its magic check
            addr = ctypes.addressof(ctypes.c_uint8.from_buffer(view))
            rc = self._lib.rt_chan_init(addr, size, nslots, slot_size)
            view.release()
            if rc != 0:
                raise RuntimeError(f"channel init failed rc={rc}")
            store.seal(oid)
            self._chan_off, _ = self._pin()
            self._base = self._map_addr() + self._chan_off
            self.slot_size = slot_size
        else:
            got = store.get_blocking(oid, timeout=30)
            if got is None:
                raise TimeoutError(f"channel object {oid} never appeared")
            view, _ = got
            view.release()
            # get_blocking pinned the object once; keep that pin for life
            self._chan_off, _ = self._query_offset()
            self._base = self._map_addr() + self._chan_off
            if self._lib.rt_chan_validate(self._base) != 0:
                raise RuntimeError(f"object {oid} is not a channel")
            self.slot_size = self._lib.rt_chan_slot_size(self._base)

    def _map_addr(self) -> int:
        return ctypes.addressof(
            ctypes.c_uint8.from_buffer(self._store._map))

    def _query_offset(self):
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        meta = ctypes.c_uint64()
        rc = self._store._lib.rt_object_get(
            self._store._handle, self.oid.binary(), ctypes.byref(off),
            ctypes.byref(size), ctypes.byref(meta))
        if rc != 0:
            raise RuntimeError("channel object vanished")
        # rt_object_get pinned it again; drop the extra pin (the original
        # one from __init__ stays)
        self._store._lib.rt_object_release(self._store._handle,
                                           self.oid.binary())
        return off.value, size.value

    def _pin(self):
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        meta = ctypes.c_uint64()
        rc = self._store._lib.rt_object_get(
            self._store._handle, self.oid.binary(), ctypes.byref(off),
            ctypes.byref(size), ctypes.byref(meta))
        if rc != 0:
            raise RuntimeError("channel object vanished after create")
        return off.value, size.value

    # -- raw byte API ---------------------------------------------------

    def try_write_bytes(self, payload) -> bool:
        n = len(payload)
        if n > self.slot_size:
            # MUST be checked before the copy: an oversized memcpy would
            # trash the next slot / neighboring store objects for every
            # process mapping the segment
            raise ValueError(
                f"payload of {n} bytes exceeds channel slot size "
                f"{self.slot_size}")
        off = self._lib.rt_chan_reserve(self._base)
        if off == -3:
            # ring closed (reader tore down, or writer hang-up): writes must
            # fail fast instead of blocking into freed/teardown state
            raise EOFError("channel closed")
        if off < 0:
            return False
        dst = self._chan_off + off
        self._store._mv[dst:dst + n] = payload
        rc = self._lib.rt_chan_commit(self._base, n)
        if rc != 0:
            raise ValueError(f"payload of {n} bytes exceeds channel slot size")
        return True

    def _wait(self, waiter, deadline: Optional[float]) -> bool:
        """One parked doorbell wait (chunked); False once the deadline has
        passed. `waiter` is rt_chan_wait_readable/_writable."""
        if deadline is None:
            waiter(self._base, int(_WAIT_CHUNK_S * 1e6))
            return True
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        waiter(self._base, int(min(remaining, _WAIT_CHUNK_S) * 1e6))
        return True

    def write_bytes(self, payload, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.try_write_bytes(payload):
            if not self._wait(self._lib.rt_chan_wait_writable, deadline):
                raise TimeoutError("channel full (consumer stalled?)")

    def try_read_bytes(self) -> Optional[bytes]:
        ln = ctypes.c_uint64()
        off = self._lib.rt_chan_acquire(self._base, ctypes.byref(ln))
        if off == -1:
            return None
        if off == -2:
            raise EOFError("channel closed by writer")
        src = self._chan_off + off
        data = bytes(self._store._mv[src:src + ln.value])
        self._lib.rt_chan_release(self._base)
        return data

    # -- zero-copy slot access (consumers that reduce/deserialize in
    # place; the ring slot is reused, so pages fault once and stay hot —
    # unlike per-transfer store objects whose fresh pages fault per call)

    def reserve_view(self, nbytes: int,
                     timeout: Optional[float] = None) -> memoryview:
        """Blocking writer half of a zero-copy write: returns a writable
        view of the next slot; fill it, then call commit(nbytes)."""
        if nbytes > self.slot_size:
            raise ValueError(
                f"payload of {nbytes} bytes exceeds channel slot size "
                f"{self.slot_size}")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            off = self._lib.rt_chan_reserve(self._base)
            if off >= 0:
                dst = self._chan_off + off
                return self._store._mv[dst:dst + nbytes]
            if off == -3:
                raise EOFError("channel closed")
            if not self._wait(self._lib.rt_chan_wait_writable, deadline):
                raise TimeoutError("channel full (consumer stalled?)")

    def commit(self, nbytes: int) -> None:
        rc = self._lib.rt_chan_commit(self._base, nbytes)
        if rc != 0:
            raise ValueError(
                f"payload of {nbytes} bytes exceeds channel slot size")

    def read_view(self, timeout: Optional[float] = None) -> memoryview:
        """Blocking reader half of a zero-copy read: returns a readonly
        view of the next slot's payload; call consume() when done (the
        view must not be used after)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ln = ctypes.c_uint64()
        while True:
            off = self._lib.rt_chan_acquire(self._base, ctypes.byref(ln))
            if off >= 0:
                src = self._chan_off + off
                return self._store._mv[src:src + ln.value].toreadonly()
            if off == -2:
                raise EOFError("channel closed by writer")
            if not self._wait(self._lib.rt_chan_wait_readable, deadline):
                raise TimeoutError("channel empty (producer stalled?)")

    def consume(self) -> None:
        self._lib.rt_chan_release(self._base)

    def prefault(self, write: bool) -> None:
        """Touch every slot's payload pages in this process's mapping so
        first transfers run at memcpy speed (no per-4KB minor faults).
        write=True is for the producer side and is only safe while the
        ring carries no committed slots."""
        self._lib.rt_chan_prefault(self._base, 1 if write else 0)

    def read_bytes(self, timeout: Optional[float] = None) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            data = self.try_read_bytes()
            if data is not None:
                return data
            if not self._wait(self._lib.rt_chan_wait_readable, deadline):
                raise TimeoutError("channel empty (producer stalled?)")

    # -- object API -----------------------------------------------------

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        from ray_tpu_torch._private import serialization as ser

        self.write_bytes(ser.serialize(value).to_bytes(), timeout)

    def read(self, timeout: Optional[float] = None) -> Any:
        from ray_tpu_torch._private import serialization as ser

        return ser.deserialize(self.read_bytes(timeout))

    def close(self) -> None:
        """Writer hang-up: readers see EOFError after draining."""
        self._lib.rt_chan_close(self._base)

    def readable(self) -> int:
        return self._lib.rt_chan_readable(self._base)

    def unpin(self) -> None:
        self._store.release(self.oid)


class RemoteChannel:
    """Writer half of a compiled-DAG edge whose ring lives on ANOTHER
    node: payload bytes ship over the worker RPC plane into the reader
    process, which lands them in its local shm ring (rpc_chan_write on
    the reader's core worker). Same write/write_bytes surface as
    ShmChannel — the executor loop can't tell the difference. Reference:
    python/ray/experimental/channel/torch_tensor_accelerator_channel.py
    (cross-node channel endpoints), redesigned for the RPC plane.

    Backpressure carries through: the reader-side write blocks on the
    ring's futex doorbell up to `timeout`, and a full ring surfaces here
    as the same TimeoutError a local writer would see."""

    def __init__(self, dag_id: str, edge: str, address: str,
                 slot_size: int = 1 << 20):
        from ray_tpu_torch._private.core_worker import get_core_worker

        self._cw = get_core_worker()
        self._dag_id = dag_id
        self._edge = edge
        self._address = address
        self.slot_size = slot_size
        # per-edge slot counter: makes chan_write idempotent under RPC
        # retries (a duplicate slot would shift every later execution)
        self._seq = 0

    async def _write_async(self, payload: bytes, timeout: Optional[float]):
        client = await self._cw._worker_client(self._address)
        rpc_timeout = 30.0 if timeout is None else timeout + 30.0
        return await client.call("chan_write", {
            "dag_id": self._dag_id,
            "edge": self._edge,
            "payload": payload,
            "seq": self._seq,
            # the reader registers its ring at executor-loop start, which
            # can queue behind earlier work on that actor — wait at least
            # as long as a same-node writer's 30s blocking open would
            "open_timeout": 60.0,
            # cap the remote blocking write so the RPC reply (and our
            # rpc_timeout above) always outlives it
            "timeout": 25.0 if timeout is None else timeout,
        }, timeout=rpc_timeout)

    def write_bytes(self, payload, timeout: Optional[float] = None) -> None:
        if len(payload) > self.slot_size:
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds channel slot "
                f"size {self.slot_size}")
        payload = bytes(payload)
        deadline = None if timeout is None else time.monotonic() + timeout
        conn_retries = 3
        while True:
            remaining = (None if deadline is None
                         else max(0.1, deadline - time.monotonic()))
            try:
                res = self._cw.run_sync(
                    self._write_async(payload, remaining),
                    timeout=(remaining or 30.0) + 60.0)
            except Exception as exc:  # noqa: BLE001 — transport failure
                # the write may or may not have landed; the seq watermark
                # makes a retry safe (duplicate slots are dropped)
                conn_retries -= 1
                if conn_retries < 0:
                    raise RuntimeError(
                        f"remote channel {self._dag_id}:{self._edge} @ "
                        f"{self._address}: transport failed ({exc})") from exc
                time.sleep(0.2)
                continue
            err = res.get("error")
            if err is None:
                self._seq += 1  # slot landed (or deduped): next slot
                return
            if err == "full":
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError("channel full (consumer stalled?)")
                continue  # timeout=None: keep blocking like a local writer
            if err.startswith("value:"):
                raise ValueError(err[len("value:"):])
            raise RuntimeError(
                f"remote channel {self._dag_id}:{self._edge} @ "
                f"{self._address}: {err}")

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        from ray_tpu_torch._private import serialization as ser

        self.write_bytes(ser.serialize(value).to_bytes(), timeout)

    def unpin(self) -> None:
        pass  # the ring is pinned by its reader
