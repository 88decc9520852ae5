"""Builds the native C++ components into shared libraries, cached by source hash.

The port's copy of ``ray_tpu/native/build.py`` (the reference builds its
native runtime with Bazel, reference: BUILD.bazel; here a minimal g++
invocation keeps the loop fast and hermetic). Artifacts land in
ray_tpu_torch/native/_build/ and are rebuilt only when sources change. The
JAX package's sanitizer builds (ASan, TSan) have no counterpart here: the
port runs no sanitizer suite. ``shm_channel`` is the compiled DAG's
channel (``experimental/channel.py``).
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


def lib_path(name: str) -> str:
    """Compile (if stale) and return the path of the shared library `name`."""
    sources = [os.path.join(_DIR, s) for s in _LIBS[name]]
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    out = os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    with _LOCK:
        if os.path.exists(out):
            return out
        os.makedirs(_BUILD, exist_ok=True)
        tmp = out + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O2", "-g", "-shared", "-fPIC", "-std=c++17",
            "-o", tmp, *sources, "-lpthread", "-lrt",
        ]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    return out
