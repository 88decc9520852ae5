"""Builds the native C++ components into shared libraries, cached by source hash.

The port's copy of ``ray_tpu/native/build.py`` (the reference builds its
native runtime with Bazel, reference: BUILD.bazel; here a minimal g++
invocation keeps the loop fast and hermetic). Artifacts land in
ray_tpu_torch/native/_build/ and are rebuilt only when sources change.
``shm_channel`` is the compiled DAG's channel (``experimental/channel.py``).

Sanitizer modes (opt-in, mutually exclusive — one runtime per process),
the JAX package's, under the same variable:

  RAY_TPU_NATIVE_SANITIZE=1|address   ASan+UBSan (reference: the bazel
      asan/ubsan config the reference's CI runs its C++ unit tests under).
  RAY_TPU_NATIVE_SANITIZE=thread      ThreadSanitizer, for the lock-free
      fastpath ring / SPSC channel / shm store memory-ordering audit
      (tests/test_torch_tsan.py drives race-amplifier workloads under it).

Sanitized artifacts are cached under a distinct tag+suffix per mode so they
never mix with production builds or each other; unset, every path and build
is the production one. Loading them into a stock CPython requires
LD_PRELOADing the sanitizer runtime — ``sanitizer_preload()`` returns the
right library (libasan or libtsan) for the active mode;
tests/test_torch_sanitize.py and tests/test_torch_tsan.py drive the flow in
subprocesses.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()

_LIBS = {
    "shm_store": ["shm_store.cc"],
    "shm_channel": ["shm_channel.cc"],
    "fastpath": ["fastpath.cc"],
}

_ASAN_FLAGS = [
    "-fsanitize=address,undefined",
    "-fno-sanitize-recover=all",
    "-fno-omit-frame-pointer",
]

_TSAN_FLAGS = [
    "-fsanitize=thread",
    "-fno-omit-frame-pointer",
]

_MODES = {
    # mode -> (compile flags, cache suffix, preload runtime soname)
    "address": (_ASAN_FLAGS, "-san", "libasan.so"),
    "thread": (_TSAN_FLAGS, "-tsan", "libtsan.so"),
}


def sanitize_mode() -> str:
    """'' | 'address' | 'thread'. The historical truthy values (1/true/...)
    keep meaning ASan+UBSan; asan and tsan cannot coexist in one process."""
    raw = os.environ.get("RAY_TPU_NATIVE_SANITIZE", "").strip().lower()
    if raw in ("1", "true", "yes", "on", "address", "asan"):
        return "address"
    if raw in ("thread", "tsan"):
        return "thread"
    return ""


def sanitize_enabled() -> bool:
    return sanitize_mode() != ""


def sanitizer_preload(mode: str | None = None) -> str:
    """Path of the sanitizer runtime to LD_PRELOAD when loading sanitized
    libraries into a non-instrumented python (libasan for mode=address,
    libtsan for mode=thread); '' when unavailable. `mode` defaults to the
    active env mode, falling back to 'address' so test harnesses can probe
    for the runtime before exporting RAY_TPU_NATIVE_SANITIZE themselves."""
    mode = mode or sanitize_mode() or "address"
    runtime = _MODES[mode][2]
    try:
        out = subprocess.run(
            ["g++", f"-print-file-name={runtime}"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return ""
    return out if out and os.path.sep in out and os.path.exists(out) else ""


def lib_path(name: str) -> str:
    """Compile (if stale) and return the path of the shared library `name`."""
    sources = [os.path.join(_DIR, s) for s in _LIBS[name]]
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    mode = sanitize_mode()
    flags, suffix = (_MODES[mode][0], _MODES[mode][1]) if mode else ([], "")
    if mode:
        h.update(b"sanitize:" + " ".join(flags).encode())
    out = os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:16]}{suffix}.so")
    if os.path.exists(out):
        return out
    with _LOCK:
        if os.path.exists(out):
            return out
        os.makedirs(_BUILD, exist_ok=True)
        tmp = out + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O2", "-g", "-shared", "-fPIC", "-std=c++17",
            *flags,
            "-o", tmp, *sources, "-lpthread", "-lrt",
        ]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    return out
