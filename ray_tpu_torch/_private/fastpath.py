"""ctypes binding + loader for the native control-plane fast path.

The engine (native/fastpath.cc) owns the submission hot loop: templated
msgpack spec encoding with interned byte fragments, a lock-free MPMC
submission ring per scheduling key, single-buffer batch frame assembly, and
a completion-side frame splitter (reference: the _raylet.pyx:3817
submit_task seam — the compiled boundary every .remote() crosses).

Everything here degrades gracefully: `new_engine()` / `new_splitter()`
return None when the `native_fastpath` flag is off, no compiler exists, or
the build/load fails for any reason, and callers run the pure-Python path
unchanged. CPU-only CI without a toolchain must stay green.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import List, Optional, Tuple

from ray_tpu_torch._private.config import GLOBAL_CONFIG

logger = logging.getLogger(__name__)

_MAX_TID = 32
_TID_SLOT = 1 + _MAX_TID

_lib = None
_load_attempted = False
_load_lock = threading.Lock()


def _load():
    """Build (if stale) and load the shared library once per process; any
    failure latches the pure-Python fallback for the process lifetime."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    with _load_lock:
        if _load_attempted:
            return _lib
        try:
            from ray_tpu_torch.native.build import lib_path

            lib = ctypes.CDLL(lib_path("fastpath"))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.rt_fp_abi_version.restype = ctypes.c_int32
            lib.rt_fp_engine_create.restype = ctypes.c_void_p
            lib.rt_fp_engine_create.argtypes = [ctypes.c_uint64]
            lib.rt_fp_engine_destroy.argtypes = [ctypes.c_void_p]
            lib.rt_fp_ring_create.restype = ctypes.c_int32
            lib.rt_fp_ring_create.argtypes = [ctypes.c_void_p]
            lib.rt_fp_template_register.restype = ctypes.c_int32
            lib.rt_fp_template_register.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_char_p, ctypes.c_uint64]
            lib.rt_fp_encode.restype = ctypes.c_int32
            lib.rt_fp_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_uint64]
            lib.rt_fp_encode_raw.restype = ctypes.c_int32
            lib.rt_fp_encode_raw.argtypes = [
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_uint64]
            lib.rt_fp_ring_len.restype = ctypes.c_uint64
            lib.rt_fp_ring_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
            lib.rt_fp_pop.restype = ctypes.c_int32
            lib.rt_fp_pop.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint64), u8p,
                ctypes.POINTER(ctypes.c_uint64)]
            lib.rt_fp_entry_free.argtypes = [ctypes.c_uint64]
            lib.rt_fp_batch_frame_size.restype = ctypes.c_uint64
            lib.rt_fp_batch_frame_size.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32,
                ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32]
            lib.rt_fp_batch_build.restype = ctypes.c_int64
            lib.rt_fp_batch_build.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32,
                ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
                u8p, ctypes.c_uint64]
            lib.rt_fp_splitter_create.restype = ctypes.c_void_p
            lib.rt_fp_splitter_destroy.argtypes = [ctypes.c_void_p]
            lib.rt_fp_splitter_feed.restype = ctypes.c_int32
            lib.rt_fp_splitter_feed.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.rt_fp_splitter_base.restype = ctypes.c_void_p
            lib.rt_fp_splitter_base.argtypes = [ctypes.c_void_p]
            lib.rt_fp_splitter_next.restype = ctypes.c_int32
            lib.rt_fp_splitter_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64)]
            if lib.rt_fp_abi_version() != 2:
                raise RuntimeError("fastpath ABI mismatch")
            _lib = lib
        except Exception:  # noqa: BLE001 — no compiler / bad toolchain / ...
            logger.info(
                "native fastpath unavailable; using the pure-Python "
                "control plane", exc_info=True)
            _lib = None
        _load_attempted = True
    return _lib


def enabled() -> bool:
    return bool(GLOBAL_CONFIG.get("native_fastpath")) and _load() is not None


def _reset_for_tests():
    """Forget a failed (or successful) load so tests can flip the flag."""
    global _lib, _load_attempted
    with _load_lock:
        _lib = None
        _load_attempted = False


class FastPathEngine:
    """One per-process submission engine; thread-safe by construction (the
    C++ ring is MPMC, registration takes the C++ mutex)."""

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native fastpath library unavailable")
        self._h = self._lib.rt_fp_engine_create(
            int(GLOBAL_CONFIG.get("fastpath_ring_slots")))
        if not self._h:
            raise RuntimeError("fastpath engine allocation failed")
        # scratch buffers for pop() — sized lazily per max batch
        self._pop_cap = 0
        self._pop_handles = None
        self._pop_tids = None
        self._pop_waits = None

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            try:
                lib.rt_fp_engine_destroy(h)
            except Exception:  # noqa: BLE001 — interpreter shutdown
                pass
            self._h = None

    def ring_create(self) -> int:
        return self._lib.rt_fp_ring_create(self._h)

    def register_template(self, pre: bytes, mid: bytes, suf: bytes) -> int:
        return self._lib.rt_fp_template_register(
            self._h, pre, len(pre), mid, len(mid), suf, len(suf))

    def encode(self, ring: int, tmpl: int, tid: bytes, args: bytes) -> int:
        """0 = queued, -1 = ring full (fall back), -2 = bad ids."""
        return self._lib.rt_fp_encode(
            self._h, ring, tmpl, tid, len(tid), args, len(args))

    def encode_raw(self, ring: int, tid: bytes, spec: bytes) -> int:
        return self._lib.rt_fp_encode_raw(
            self._h, ring, tid, len(tid), spec, len(spec))

    def ring_len(self, ring: int) -> int:
        return self._lib.rt_fp_ring_len(self._h, ring)

    def pop(self, ring: int, max_n: int) -> List[Tuple[int, bytes, int]]:
        """Pop up to max_n encoded specs; returns
        [(handle, task_id, ring_wait_ns)] — the wait is the entry's ring
        residency stamped by the C++ side (the ring_wait hop). The caller
        owns every popped handle: each must reach either build_frame() or
        entry_free()."""
        if max_n > self._pop_cap:
            self._pop_cap = max_n
            self._pop_handles = (ctypes.c_uint64 * max_n)()
            self._pop_tids = (ctypes.c_uint8 * (_TID_SLOT * max_n))()
            self._pop_waits = (ctypes.c_uint64 * max_n)()
        n = self._lib.rt_fp_pop(
            self._h, ring, max_n, self._pop_handles,
            ctypes.cast(self._pop_tids, ctypes.POINTER(ctypes.c_uint8)),
            self._pop_waits)
        out = []
        raw = bytes(self._pop_tids[:n * _TID_SLOT])
        for i in range(n):
            slot = raw[i * _TID_SLOT:(i + 1) * _TID_SLOT]
            out.append((self._pop_handles[i], slot[1:1 + slot[0]],
                        self._pop_waits[i]))
        return out

    def entry_free(self, handle: int) -> None:
        self._lib.rt_fp_entry_free(handle)

    def build_frame(self, handles: List[int], req_id: int,
                    method: bytes = b"push_task_batch") -> Optional[bytes]:
        """Assemble one complete length-prefixed RPC frame from popped
        entries (consumes them). None only for an over-limit frame — the
        entries then remain owned by the caller."""
        n = len(handles)
        arr = (ctypes.c_uint64 * n)(*handles)
        size = self._lib.rt_fp_batch_frame_size(
            arr, n, req_id, method, len(method))
        buf = (ctypes.c_uint8 * size)()
        written = self._lib.rt_fp_batch_build(
            arr, n, req_id, method, len(method),
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), size)
        if written < 0:
            return None
        return bytes(buf[:written])


class FrameSplitter:
    """Incremental frame carving for one RPC connection's inbound stream."""

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native fastpath library unavailable")
        self._h = self._lib.rt_fp_splitter_create()
        self._frame_off = ctypes.c_uint64()
        self._frame_len = ctypes.c_uint64()
        self._kind = ctypes.c_uint32()
        self._req_id = ctypes.c_uint64()
        self._method_off = ctypes.c_uint64()
        self._method_len = ctypes.c_uint32()
        self._payload_off = ctypes.c_uint64()
        self._payload_len = ctypes.c_uint64()

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            try:
                lib.rt_fp_splitter_destroy(h)
            except Exception:  # noqa: BLE001 — interpreter shutdown
                pass
            self._h = None

    def feed(self, data: bytes) -> None:
        if self._lib.rt_fp_splitter_feed(self._h, data, len(data)) != 0:
            raise MemoryError("fastpath splitter allocation failed")

    def next(self):
        """Next complete frame, or None.

        Returns (kind, req_id, method_bytes, payload_bytes) when the header
        pre-parsed, or (None, None, None, whole_frame_bytes) when it did not
        (the caller unpacks the whole frame). Raises ValueError on an
        oversized frame (protocol violation)."""
        rc = self._lib.rt_fp_splitter_next(
            self._h, ctypes.byref(self._frame_off),
            ctypes.byref(self._frame_len), ctypes.byref(self._kind),
            ctypes.byref(self._req_id), ctypes.byref(self._method_off),
            ctypes.byref(self._method_len), ctypes.byref(self._payload_off),
            ctypes.byref(self._payload_len))
        if rc == 0:
            return None
        if rc < 0:
            raise ValueError("frame exceeds transport limit")
        base = self._lib.rt_fp_splitter_base(self._h)
        if self._kind.value == 0xFFFFFFFF:
            whole = ctypes.string_at(
                base + self._frame_off.value, self._frame_len.value)
            return (None, None, None, whole)
        method = ctypes.string_at(
            base + self._method_off.value, self._method_len.value)
        payload = ctypes.string_at(
            base + self._payload_off.value, self._payload_len.value)
        return (self._kind.value, self._req_id.value, method, payload)


def new_engine() -> Optional[FastPathEngine]:
    if not enabled():
        return None
    try:
        return FastPathEngine()
    except Exception:  # noqa: BLE001 — never fail the caller over a fast path
        logger.info("fastpath engine creation failed", exc_info=True)
        return None


def new_splitter() -> Optional[FrameSplitter]:
    if not enabled():
        return None
    try:
        return FrameSplitter()
    except Exception:  # noqa: BLE001
        return None


def build_template(engine: FastPathEngine, spec) -> int:
    """Split the wire encoding of `spec` around its two per-task fields
    (task_id, args) and intern the three constant fragments in the engine.
    Returns the template id, or -1 when this spec's shape can't be
    templated (the caller keeps the untemplated path)."""
    import os

    import msgpack

    tid_sentinel = os.urandom(16)
    args_sentinel = os.urandom(16)
    w = spec.to_wire()
    w["task_id"] = tid_sentinel
    w["args"] = args_sentinel
    try:
        blob = msgpack.packb(w, use_bin_type=True)
    except Exception:  # noqa: BLE001 — unpackable field (shouldn't happen)
        return -1
    tid_tok = b"\xc4\x10" + tid_sentinel
    args_tok = b"\xc4\x10" + args_sentinel
    if blob.count(tid_tok) != 1 or blob.count(args_tok) != 1:
        return -1
    i = blob.index(tid_tok)
    j = blob.index(args_tok)
    if j < i:
        return -1  # wire order changed; don't guess
    pre = blob[:i]
    mid = blob[i + len(tid_tok):j]
    suf = blob[j + len(args_tok):]
    return engine.register_template(pre, mid, suf)
