"""Object serialization: pickle protocol-5 with out-of-band buffers.

Capability parity with the reference's serialization layer
(reference: python/ray/_private/serialization.py + msgpack/pickle5 split): values are
pickled with protocol 5 so large contiguous buffers (numpy arrays, arrow buffers,
bytes) are carried out-of-band and can be written into / read from shared memory
with zero copies. The wire format is:

    [u32 nbuffers][u64 len_pickle][pickle bytes][u64 len_buf_i ...][buf_i ...]

ObjectRefs found inside a value are serialized by identity and re-hydrated on the
receiving side with ownership metadata (borrowing), matching the reference's
ownership-based ref counting design (reference: src/ray/core_worker/reference_counter.h:44).

torch tensors (the port's counterpart of the JAX package's jax.Array hook)
carry their bytes as one out-of-band buffer. While the
``device_object_transport`` flag is on (the default) the device object plane
(``experimental/rdt.py``) registers the live tensor too: a get in the
process that put it returns the original tensor, unchanged since the put,
with no copy; any other process, or a tensor written since, is rebuilt from
the bytes (a CUDA tensor on the receiving process's current CUDA device).
With the flag off every get rebuilds.
"""

from __future__ import annotations

import contextvars
import io
import pickle
import struct
import sys
import warnings
from typing import Any, List

_HEADER = struct.Struct("<IQ")
_LEN = struct.Struct("<Q")


def _reduce_tensor(obj):
    """A plain torch tensor as (rebuild, args) with its bytes as one
    protocol-5 buffer; NotImplemented for anything else (subclasses such as
    Parameter, sparse or quantized tensors keep torch's own pickling)."""
    torch = sys.modules["torch"]
    if type(obj) is not torch.Tensor or obj.layout != torch.strided:
        return NotImplemented
    host = obj.detach()
    if host.device.type != "cpu":
        host = host.cpu()
    raw = host.contiguous().reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(obj.dtype).split(".")[1],
             tuple(obj.shape), obj.device.type, obj.requires_grad))


def _rebuild_tensor(buf, dtype: str, shape, device_type: str,
                    requires_grad: bool):
    """The receiving side of ``_reduce_tensor``. The bytes are copied first
    (the buffer may be a read-only, unaligned view of the shared-memory
    store): onto this process's current CUDA device for a CUDA tensor, into
    fresh host memory otherwise. A CUDA tensor never lands on the CPU."""
    import torch

    mv = memoryview(buf)
    if mv.nbytes == 0:
        flat = torch.empty(0, dtype=torch.uint8)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # read-only: only copied from
            flat = torch.frombuffer(mv, dtype=torch.uint8)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA tensor reached a process without CUDA; ask for "
                "num_gpus on the task or actor that reads it")
        flat = flat.to(torch.device("cuda", torch.cuda.current_device()))
    elif device_type == "cpu":
        flat = flat.clone()
    else:
        raise TypeError(f"cannot rebuild a {device_type} tensor")
    t = flat.view(getattr(torch, dtype)).reshape(shape)
    return t.requires_grad_() if requires_grad else t


def _reduce(obj):
    """The tensor hook: the device object plane's while the
    ``device_object_transport`` flag is on, ``_reduce_tensor`` otherwise."""
    torch = sys.modules["torch"]
    if type(obj) is not torch.Tensor:
        return NotImplemented
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if GLOBAL_CONFIG.get("device_object_transport"):
        from ray_tpu_torch.experimental.rdt import maybe_reduce_device_tensor

        return maybe_reduce_device_tensor(obj)
    return _reduce_tensor(obj)


class _Pickler(pickle.Pickler):
    """Protocol-5 pickler with the device-tensor transport hook (reference:
    python/ray/experimental/rdt — tensors move out-of-band; see
    ray_tpu_torch/experimental/rdt.py)."""

    def reducer_override(self, obj):
        return _reduce(obj)


def _make_cloud_pickler_cls():
    import cloudpickle

    class _CloudPickler(cloudpickle.Pickler):
        def reducer_override(self, obj):
            if "torch" in sys.modules:
                r = _reduce(obj)
                if r is not NotImplemented:
                    return r
            return super().reducer_override(obj)

    return _CloudPickler


_cloud_pickler_cls = None


class SerializedObject:
    """A serialized value: a metadata pickle plus zero-copy buffers."""

    __slots__ = ("inband", "buffers", "contained_refs")

    def __init__(self, inband: bytes, buffers: List[memoryview], contained_refs: list):
        self.inband = inband
        self.buffers = buffers
        self.contained_refs = contained_refs

    @property
    def total_bytes(self) -> int:
        return (
            _HEADER.size
            + len(self.inband)
            + sum(_LEN.size + len(b) for b in self.buffers)
        )

    def to_bytes(self) -> bytes:
        out = bytearray()
        self.write_into(out)
        return bytes(out)

    def write_into(self, out) -> None:
        """Write the wire format into a writable buffer-like (bytearray or memoryview)."""
        if isinstance(out, bytearray):
            out += _HEADER.pack(len(self.buffers), len(self.inband))
            out += self.inband
            for b in self.buffers:
                out += _LEN.pack(len(b))
                out += b
        else:
            # memoryview over shm: copy segments at offsets
            off = 0
            _HEADER.pack_into(out, off, len(self.buffers), len(self.inband))
            off += _HEADER.size
            out[off : off + len(self.inband)] = self.inband
            off += len(self.inband)
            for b in self.buffers:
                _LEN.pack_into(out, off, len(b))
                off += _LEN.size
                out[off : off + len(b)] = b
                off += len(b)


def serialize(value: Any) -> SerializedObject:
    """Serialize `value`. ObjectRefs inside the value register themselves with
    the active serialization context (see runtime/context.py) via __reduce__,
    which appends to `contained_refs` for borrow tracking."""
    buffers: List[memoryview] = []

    def buffer_callback(buf: pickle.PickleBuffer) -> bool:
        buffers.append(buf.raw())
        return False  # do not also serialize in-band

    # The tensor hook costs a Python callback per pickled object; keep the
    # pure-C pickle.dumps fast path when no tensor can exist (torch never
    # imported).
    use_hook = "torch" in sys.modules

    token = _CONTAINED_REFS.set([])
    try:
        try:
            if use_hook:
                f = io.BytesIO()
                _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(value)
                inband = f.getvalue()
            else:
                inband = pickle.dumps(
                    value, protocol=5, buffer_callback=buffer_callback
                )
            if b"__main__" in inband:
                # plain pickle serialized a __main__-defined class/function
                # BY REFERENCE — unimportable in worker processes (their
                # __main__ is default_worker). cloudpickle serializes
                # __main__ definitions by value; rare false positives (user
                # bytes containing the literal) just take the slower path.
                raise pickle.PicklingError("__main__ by-reference")
        except (pickle.PicklingError, AttributeError, TypeError):
            # lambdas / closures / local classes (e.g. Dataset UDFs riding as
            # task args): cloudpickle, same protocol-5 out-of-band buffers
            # (reference: ray cloudpickles all task arguments)
            global _cloud_pickler_cls
            if _cloud_pickler_cls is None:
                _cloud_pickler_cls = _make_cloud_pickler_cls()
            buffers.clear()
            refs = _CONTAINED_REFS.get()
            if refs:
                refs.clear()  # re-collected by the retry
            f = io.BytesIO()
            _cloud_pickler_cls(
                f, protocol=5, buffer_callback=buffer_callback
            ).dump(value)
            inband = f.getvalue()
        contained = _CONTAINED_REFS.get()
    finally:
        _CONTAINED_REFS.reset(token)
    return SerializedObject(inband, buffers, contained)


# Active collector for ObjectRefs encountered during a serialize() call.
# ObjectRef.__reduce__ calls note_contained_ref() so the owner can be told about
# borrows (reference: reference_counter.h borrowing protocol).
_CONTAINED_REFS: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "rtpu_contained_refs", default=None
)


def note_contained_ref(ref) -> None:
    lst = _CONTAINED_REFS.get()
    if lst is not None:
        lst.append(ref)


class _Pin:
    """Calls `release` exactly once when the last referrer drops.

    Shared by every out-of-band buffer of one deserialized value: once all
    arrays aliasing the shm segment are GC'd, the store pin is released and
    the object becomes evictable again (reference: plasma/client.h Release
    protocol — pin lifetime == buffer lifetime).
    """

    __slots__ = ("_release",)

    def __init__(self, release):
        self._release = release

    def __del__(self):
        try:
            self._release()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class _PinnedBuffer:
    """Buffer-protocol exporter (PEP 688) holding a _Pin alive.

    numpy keeps the exporter object as the array base, so the pin lives as
    long as any array view over this buffer does.
    """

    __slots__ = ("_mv", "_pin")

    def __init__(self, mv, pin):
        self._mv = mv
        self._pin = pin

    def __buffer__(self, flags):
        return memoryview(self._mv)


# Pure-Python buffer exporters (PEP 688 __buffer__) only exist on CPython
# 3.12+. Older interpreters can't tie a store pin to array lifetime, so
# they must COPY out-of-band buffers and release the pin eagerly — correct
# reads at the cost of zero-copy (a _PinnedBuffer handed to np.frombuffer
# on 3.10 is a TypeError, and handing the raw shm view instead would free
# the pin while arrays still alias the segment).
_CAN_PIN_BUFFERS = sys.version_info >= (3, 12)


def deserialize(data, copy_buffers: bool = False, release=None) -> Any:
    """Deserialize from bytes/memoryview produced by SerializedObject.

    When `data` is a memoryview over shared memory and copy_buffers is False,
    numpy arrays in the value alias the shm segment (zero-copy reads), exactly
    like the reference's plasma-backed numpy views (reference: plasma/client.h).

    `release`, if given, is called once the deserialized value no longer
    references `data` (immediately when everything was copied in-band, or when
    the last aliasing array is GC'd otherwise).
    """
    if release is not None and not copy_buffers and not _CAN_PIN_BUFFERS:
        # a pin would be needed but this interpreter can't export buffers
        # from Python (see _CAN_PIN_BUFFERS): copy + eager release instead.
        # Pin-less zero-copy over plain bytes (inline objects) stays.
        copy_buffers = True
    mv = memoryview(data)
    nbuf, inband_len = _HEADER.unpack_from(mv, 0)
    off = _HEADER.size
    inband = mv[off : off + inband_len]
    off += inband_len
    pin = _Pin(release) if (release is not None and not copy_buffers) else None
    bufs = []
    for _ in range(nbuf):
        (blen,) = _LEN.unpack_from(mv, off)
        off += _LEN.size
        b = mv[off : off + blen]
        if copy_buffers:
            b = memoryview(bytes(b))
        bufs.append(b if pin is None else _PinnedBuffer(b, pin))
        off += blen
    try:
        value = pickle.loads(inband, buffers=bufs)
    finally:
        # pickle copies in-band data; if no out-of-band buffer survived into
        # the value, `pin`'s last reference drops here and release fires.
        del bufs, pin
    if release is not None and copy_buffers:
        release()
    return value
