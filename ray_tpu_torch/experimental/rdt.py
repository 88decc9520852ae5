"""Device-direct object transport for torch tensors (the port's copy of
``ray_tpu/experimental/rdt.py``, the JAX package's TPU RDT).

Reference surface: python/ray/experimental/rdt/ (rdt_manager.py, the NIXL /
CUDA-IPC tensor transports) — GPU tensors move out-of-band while the object
store holds metadata. As in the JAX package: a tensor put into the object
plane keeps living in its producer process (on its CUDA device); the store
carries a host-staged copy (``serialization._reduce_tensor``'s raw bytes
and dtype name, so bf16 survives) plus a transport id. A consumer in the
SAME process gets the original tensor back untouched (no host-to-device
upload, `is`-identical while the producer's tensor is alive); a consumer
elsewhere rebuilds from the host bytes (``serialization._rebuild_tensor``:
onto its current CUDA device for a CUDA tensor). No CUDA IPC between
processes, as the JAX package has no device path between processes.

A jax.Array is immutable; a torch tensor is not (AdamW updates parameters
in place), and a get must never return values written after the put. So
registration records the tensor's version counter, its storage's data
pointer and its storage's size: a bumped version (any in-place op on the
tensor or a view of it), a storage swapped (``t.data = ...``) or resized
to 0 (ZeRO-style freeing) makes the lookup a host rebuild, the
counterpart of the JAX package's ``is_deleted()`` check. An in-place write
through ``t.data`` (a tensor with a version counter of its own) is not
seen.
"""

from __future__ import annotations

import os
import weakref
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

_STRONG_CAP = 256


def _signature(obj: Any) -> Optional[Tuple[int, int, int]]:
    """(version, storage data pointer, storage bytes) of a tensor; None for
    anything without them."""
    try:
        storage = obj.untyped_storage()
        return (obj._version, storage.data_ptr(), storage.nbytes())
    except Exception:  # noqa: BLE001 — not a tensor
        return None


class DeviceObjectManager:
    """Process-local registry of live tensors keyed by transport id.

    Weak references wherever the type allows them (the registry must not
    pin device memory the producer has dropped); a bounded strong-ref LRU
    otherwise."""

    def __init__(self, strong_cap: int = _STRONG_CAP):
        self._weak: Dict[bytes, weakref.ref] = {}
        self._strong: "OrderedDict[bytes, Any]" = OrderedDict()
        self._strong_cap = strong_cap
        # the tensor's signature at registration (see the module docstring)
        self._signatures: Dict[bytes, Optional[Tuple[int, int, int]]] = {}
        # transport outcome counters: `device_hits` = same-process consumer
        # got the original tensor back untouched; `host_rebuilds` = the
        # consumer rebuilt from the host staging bytes (cross-process, or
        # the producer changed, freed or dropped the tensor).
        self.stats: Dict[str, int] = {"registered": 0, "device_hits": 0,
                                      "host_rebuilds": 0}

    def _forget(self, tid: bytes):
        self._weak.pop(tid, None)
        self._signatures.pop(tid, None)

    def register(self, arr: Any) -> bytes:
        tid = os.urandom(16)
        self.stats["registered"] += 1
        self._signatures[tid] = _signature(arr)
        try:
            self._weak[tid] = weakref.ref(
                arr, lambda _r, t=tid: self._forget(t)
            )
        except TypeError:
            self._strong[tid] = arr
            while len(self._strong) > self._strong_cap:
                old, _ = self._strong.popitem(last=False)
                self._signatures.pop(old, None)
        return tid

    def lookup(self, tid: bytes) -> Optional[Any]:
        r = self._weak.get(tid)
        if r is not None:
            return r()
        arr = self._strong.get(tid)
        if arr is not None:
            self._strong.move_to_end(tid)  # true LRU: hot entries survive
        return arr

    def unchanged(self, tid: bytes, arr: Any) -> bool:
        """Whether ``arr`` still holds what it held when registered: same
        version, same storage, storage not freed."""
        sig = self._signatures.get(tid)
        # a storage freed since (resized to 0) changes the size too
        return sig is None or _signature(arr) == sig

    def __len__(self) -> int:
        return len(self._weak) + len(self._strong)


_manager: Optional[DeviceObjectManager] = None


def device_object_manager() -> DeviceObjectManager:
    global _manager
    if _manager is None:
        _manager = DeviceObjectManager()
    return _manager


def _rebuild_device_tensor(tid: bytes, *host: Any) -> Any:
    """Unpickle hook: same-process → the original tensor, unless it changed
    since the put; elsewhere → rebuild from the host staging bytes
    (``host`` is ``_reduce_tensor``'s argument tuple)."""
    mgr = device_object_manager()
    arr = mgr.lookup(tid)
    if arr is not None and mgr.unchanged(tid, arr):
        mgr.stats["device_hits"] += 1
        return arr
    from ray_tpu_torch._private.serialization import _rebuild_tensor

    mgr.stats["host_rebuilds"] += 1
    return _rebuild_tensor(*host)


def maybe_reduce_device_tensor(obj: Any):
    """Custom-reduce hook used by the serializer while the
    ``device_object_transport`` flag is on: a plain strided tensor (CPU or
    CUDA) becomes (transport id, host bytes) with the live tensor
    registered out-of-band. NotImplemented for everything else (torch's own
    pickling then)."""
    from ray_tpu_torch._private.serialization import _reduce_tensor

    reduced = _reduce_tensor(obj)  # one device-to-host copy for a CUDA tensor
    if reduced is NotImplemented:
        return NotImplemented
    tid = device_object_manager().register(obj)
    return (_rebuild_device_tensor, (tid, *reduced[1]))


__all__ = [
    "DeviceObjectManager",
    "device_object_manager",
    "maybe_reduce_device_tensor",
]
