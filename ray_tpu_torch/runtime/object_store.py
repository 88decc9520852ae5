"""Python client for the native shared-memory object store.

Capability parity with the reference's plasma client
(reference: src/ray/object_manager/plasma/client.h — mmap'd zero-copy reads,
create/seal/get/release/delete/contains), bound via ctypes to
ray_tpu_torch/native/shm_store.cc instead of a socket protocol with fd passing: every
process maps the same named shm segment, so a `get` returns a memoryview that
aliases store memory with no copies and no server round-trip.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional, Tuple

from ray_tpu_torch._private.errors import ObjectStoreFullError, RayTpuSystemError
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.native.build import lib_path

# metadata bits stored with each object
META_NORMAL = 0
META_ERROR = 1  # payload is a serialized exception


class _Lib:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            lib = ctypes.CDLL(lib_path("shm_store"))
            lib.rt_store_create.restype = ctypes.c_void_p
            lib.rt_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
            lib.rt_store_open.restype = ctypes.c_void_p
            lib.rt_store_open.argtypes = [ctypes.c_char_p]
            lib.rt_store_close.argtypes = [ctypes.c_void_p]
            lib.rt_store_destroy.argtypes = [ctypes.c_char_p]
            lib.rt_object_create.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.rt_object_create_ex.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.rt_object_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_object_get.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.rt_object_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_object_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_object_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rt_store_stats.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint64)] * 4
            lib.rt_store_list_evictable.restype = ctypes.c_uint64
            lib.rt_store_list_evictable.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ]
            lib.rt_store_base.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.rt_store_base.argtypes = [ctypes.c_void_p]
            lib.rt_store_map_size.restype = ctypes.c_uint64
            lib.rt_store_map_size.argtypes = [ctypes.c_void_p]
            cls._instance = lib
        return cls._instance


RT_OK = 0
RT_ERR_EXISTS = -1
RT_ERR_NOT_FOUND = -2
RT_ERR_FULL = -3
RT_ERR_STATE = -4


class ShmObjectStore:
    """Handle to a node's shm object store. Thread-safe (locking is in the shm)."""

    def __init__(self, name: str, create: bool = False, size: int = 0,
                 capacity: int = 65536, allow_evict: bool | None = None):
        self._lib = _Lib()
        self.name = name
        if allow_evict is None:
            # A full store returns FULL: the daemon spills (when enabled)
            # and creators BACKPRESSURE until capacity appears (reference:
            # plasma create_request_queue.h — primary copies are never
            # destroyed; eviction deleting a sole copy would turn a full
            # store into silent data loss). Destructive in-store LRU
            # eviction is an explicit cache-semantics opt-in.
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            allow_evict = GLOBAL_CONFIG.get("object_store_destructive_eviction")
        self._allow_evict = 1 if allow_evict else 0
        # serializes close() against GC-driven release()/contains()/delete()
        # (zero-copy pin finalizers fire on arbitrary threads at shutdown;
        # rt_store_close munmaps + frees, so a handle snapshot alone would
        # race a close into use-after-free). Re-entrant: a pin finalizer can
        # run inside an allocation made under this lock by the same thread.
        self._close_lock = threading.RLock()
        if create:
            self._handle = self._lib.rt_store_create(name.encode(), size, capacity)
        else:
            self._handle = self._lib.rt_store_open(name.encode())
        if not self._handle:
            raise RayTpuSystemError(f"Failed to {'create' if create else 'open'} shm store {name}")
        base = self._lib.rt_store_base(self._handle)
        map_size = self._lib.rt_store_map_size(self._handle)
        # Data offsets are relative to base; one view over the whole mapping.
        self._map = (ctypes.c_uint8 * map_size).from_address(
            ctypes.addressof(base.contents)
        )
        self._mv = memoryview(self._map).cast("B")

    def _raw_stats(self) -> Tuple[int, int, int, int]:
        a, b, c, d = (ctypes.c_uint64() for _ in range(4))
        self._lib.rt_store_stats(self._handle, a, b, c, d)
        return a.value, b.value, c.value, d.value

    def stats(self) -> dict:
        bytes_in_use, num_objects, heap_size, seal_seq = self._raw_stats()
        return {
            "bytes_in_use": bytes_in_use,
            "num_objects": num_objects,
            "heap_size": heap_size,
            "seal_seq": seal_seq,
        }

    def list_evictable(self, max_n: int = 256) -> list:
        """Spill candidates (sealed, unpinned) as [(ObjectID, size)], LRU-first."""
        ids = (ctypes.c_uint8 * (24 * max_n))()
        sizes = (ctypes.c_uint64 * max_n)()
        n = self._lib.rt_store_list_evictable(
            self._handle, ids,
            ctypes.cast(sizes, ctypes.POINTER(ctypes.c_uint64)), max_n,
        )
        raw = bytes(ids)
        return [
            (ObjectID(raw[i * 24:(i + 1) * 24]), sizes[i]) for i in range(n)
        ]

    def create(self, object_id: ObjectID, size: int, metadata: int = META_NORMAL) -> memoryview:
        """Allocate an object and return a writable view; call seal() when done.

        With allow_evict off (the default while spilling is enabled), a
        failed allocation raises ObjectStoreFullError instead of destroying
        LRU objects — the caller asks the daemon to spill and retries."""
        off = ctypes.c_uint64()
        rc = self._lib.rt_object_create_ex(
            self._handle, object_id.binary(), size, metadata, self._allow_evict,
            ctypes.byref(off)
        )
        if rc == RT_ERR_EXISTS:
            raise FileExistsError(f"Object {object_id} already in store")
        if rc == RT_ERR_FULL:
            raise ObjectStoreFullError(
                f"Store {self.name} full creating {size} bytes for {object_id}"
            )
        if rc != RT_OK:
            raise RayTpuSystemError(f"create failed rc={rc}")
        return self._mv[off.value : off.value + size]

    def seal(self, object_id: ObjectID) -> None:
        rc = self._lib.rt_object_seal(self._handle, object_id.binary())
        if rc != RT_OK:
            raise RayTpuSystemError(f"seal {object_id} failed rc={rc}")

    def get(self, object_id: ObjectID) -> Optional[Tuple[memoryview, int]]:
        """Pin + return (zero-copy readonly view, metadata), or None if absent.

        Caller must release() when the view (and anything aliasing it) is dropped.
        """
        off, size, meta = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
        rc = self._lib.rt_object_get(
            self._handle, object_id.binary(), ctypes.byref(off), ctypes.byref(size),
            ctypes.byref(meta),
        )
        if rc == RT_ERR_NOT_FOUND:
            return None
        if rc != RT_OK:
            raise RayTpuSystemError(f"get {object_id} failed rc={rc}")
        # Readonly so a reader can't corrupt the sealed object for every
        # process on the node (sealed objects are immutable, like plasma's).
        view = self._mv[off.value : off.value + size.value].toreadonly()
        return view, meta.value

    def get_blocking(self, object_id: ObjectID, timeout: float | None = None,
                     poll_s: float = 0.001) -> Optional[Tuple[memoryview, int]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            res = self.get(object_id)
            if res is not None:
                return res
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(poll_s)

    def release(self, object_id: ObjectID) -> None:
        # Zero-copy pins (_Pin finalizers) are released by GC and routinely
        # outlive close() at shutdown; a NULL handle into the native lib is
        # a segfault, not an error return — and close() munmaps, so the
        # check must hold the close lock, not just snapshot the handle.
        with self._close_lock:
            if not self._handle:
                return
            self._lib.rt_object_release(self._handle, object_id.binary())

    def contains(self, object_id: ObjectID) -> bool:
        with self._close_lock:
            if not self._handle:
                return False
            return bool(
                self._lib.rt_object_contains(self._handle, object_id.binary()))

    def delete(self, object_id: ObjectID) -> bool:
        with self._close_lock:
            if not self._handle:
                return False
            return self._lib.rt_object_delete(
                self._handle, object_id.binary()) == RT_OK

    def put_bytes(self, object_id: ObjectID, data, metadata: int = META_NORMAL) -> None:
        """Convenience: create+copy+seal in one call."""
        view = self.create(object_id, len(data), metadata)
        view[:] = data
        self.seal(object_id)

    def close(self) -> None:
        with self._close_lock:
            if self._handle:
                # Drop the ctypes view before unmapping; a re-entrant
                # release() during the close finds no handle.
                self._mv.release()
                del self._map
                handle, self._handle = self._handle, None
                self._lib.rt_store_close(handle)

    def destroy(self) -> None:
        name = self.name
        self.close()
        self._lib.rt_store_destroy(name.encode())
