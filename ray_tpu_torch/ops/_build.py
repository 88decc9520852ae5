"""Builds the hand-written CUDA kernels into shared libraries, cached by
source hash, and loads them with ctypes.

Each kernel source under ``ray_tpu_torch/csrc/`` exposes a plain C entry
point (``flash_fwd.cu``: K1; ``flash_bwd.cu``: K2, and K5a as its
fp32-output launch; ``flash_bwd_dkv.cu``: K3, and K5b likewise;
``flash_chunk.cu``: K4; K1 and K4 share ``hopper_attn.cuh``, which with K2
and K3 runs on ``hopper_common.cuh``), so the build is one ``nvcc`` call
per source with no PyTorch headers (seconds, not the minutes a
torch-extension build takes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so \
         csrc/<name>.cu

Artifacts land in ``ray_tpu_torch/_build/`` and are rebuilt only when the
source or a shared header (``csrc/*.cuh``) changes (modelled on
``ray_tpu/native/build.py``). ``build_all`` starts every stale build at
once, so a run that needs several kernels pays for the slowest, not the
sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()

# library name -> C entry points: (restype, argtypes). Every pointer and the
# stream are c_void_p: an undeclared argument goes through ctypes as a 32-bit
# int and cuts the pointer.
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    "flash_fwd": {
        # q, k, v, o, lse, b, h, kvh, s, hd, causal, stream
        "flash_fwd_bf16": (ctypes.c_int,
                           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    },
    "flash_bwd": {
        # q, k, v, dO, o (or null: delta is read), lse, delta, dq, b, h,
        # kvh, sq, sk, hd, causal, dq_fp32, stream
        "flash_bwd_dq": (ctypes.c_int, [_P] * 8 + [_I] * 8 + [_P]),
    },
    "flash_bwd_dkv": {
        # q, k, v, dO, lse, delta, dk, dv, b, h, kvh, sq, sk, hd, causal,
        # dkv_fp32, stream
        "flash_bwd_dkv": (ctypes.c_int, [_P] * 8 + [_I] * 8 + [_P]),
    },
    "flash_chunk": {
        # q, k, v, o_in, m_in, l_in, o_out, m_out, l_out, b, h, kvh, sq, sk,
        # hd, causal, stream
        "flash_chunk_bf16": (ctypes.c_int, [_P] * 9 + [_I] * 7 + [_P]),
    },
}

# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills; ``build_all`` keeps the report beside the library (``log_path``)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of ray_tpu_torch build on a machine with the "
                       "CUDA toolkit")


def lib_path(name: str) -> str:
    """Path of the shared library for ``csrc/<name>.cu``, keyed by the hash
    of the source and of the headers beside it (whether or not it is built
    yet)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu"] + headers:
        with open(os.path.join(_CSRC, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """The compiler's output (ptxas's register and spill report) of the
    library ``lib_path(name)``, written when it was built."""
    return lib_path(name) + ".log"


def build_all(names: Sequence[str] = tuple(_ENTRIES)) -> Dict[str, str]:
    """Compile every stale library in ``names`` with one ``nvcc`` process
    each, all started together. Returns name -> path; raises with the
    compiler's output if any build fails."""
    paths = {n: lib_path(n) for n in names}
    with _LOCK:
        stale = [n for n in names if not os.path.exists(paths[n])]
        if not stale:
            return paths
        os.makedirs(_BUILD, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for n in stale:
            tmp = f"{paths[n]}.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(_CSRC, f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors: List[str] = []
        for n, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc {n}.cu failed ({p.returncode}):\n{out}")
                continue
            with open(log_path(n), "w") as f:
                f.write(out)
            os.replace(tmp, paths[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its entry points declared, built
    first if stale."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build_all([name])[name])
    for fn, (restype, argtypes) in _ENTRIES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _loaded[name] = lib
    return lib
