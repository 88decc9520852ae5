"""The port's sanitizer builds of its native surface (``shm_store``,
``shm_channel``, ``fastpath``: byte-identical copies of the JAX package's
C++), against the JAX package's (``tests/test_sanitize.py``).

Fast (tier-1): ``ray_tpu_torch.native.build`` reads
``RAY_TPU_NATIVE_SANITIZE`` as ``ray_tpu.native.build`` does, builds with
the same flags into the same cache names, and leaves the unset path as it
was; all checked without compiling.

Slow: the port's suites that drive the three libraries run in a child
interpreter with RAY_TPU_NATIVE_SANITIZE=1 and libasan LD_PRELOADed, so
every library any process of theirs loads (the pytest worker, the torch
child, the cluster's store, daemon and workers inherit the environment) is
the ASan+UBSan build. A sanitizer hit aborts that process
(-fno-sanitize-recover) and fails the assertion here.
"""

import hashlib
import os
import shutil
import subprocess
import sys
from unittest import mock

import pytest

from ray_tpu.native import build as jax_build
from ray_tpu_torch.native import build

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIBS = ("shm_store", "shm_channel", "fastpath")
_SANITIZER_MARKERS = ("AddressSanitizer", "UndefinedBehaviorSanitizer",
                      "runtime error:")


# ---------------------------------------------------------------------------
# fast: the modes, flags and cache names are the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw, mode", [
    ("", ""), ("1", "address"), ("true", "address"), ("address", "address"),
    ("asan", "address"), ("thread", "thread"), ("tsan", "thread"),
    ("bogus", ""),
])
def test_sanitize_mode_matches_the_jax_package(monkeypatch, raw, mode):
    monkeypatch.setenv("RAY_TPU_NATIVE_SANITIZE", raw)
    assert build.sanitize_mode() == jax_build.sanitize_mode() == mode
    assert build.sanitize_enabled() == jax_build.sanitize_enabled() == (
        mode != "")


def test_flag_sets_and_suffixes_are_the_jax_packages():
    assert build._ASAN_FLAGS == jax_build._ASAN_FLAGS
    assert build._TSAN_FLAGS == jax_build._TSAN_FLAGS
    assert build._MODES == jax_build._MODES
    assert {m: v[1] for m, v in build._MODES.items()} == {
        "address": "-san", "thread": "-tsan"}


def _cached_name(mod, name):
    """``mod.lib_path(name)``'s file name, as if the library were built:
    nothing is compiled."""
    with mock.patch("os.path.exists", return_value=True):
        return os.path.basename(mod.lib_path(name))


@pytest.mark.parametrize("name", _LIBS)
def test_unset_path_is_the_production_build(monkeypatch, name):
    """Unset, the library's name is the one it had before sanitizer modes
    came: the source's hash alone, no suffix."""
    monkeypatch.delenv("RAY_TPU_NATIVE_SANITIZE", raising=False)
    with open(os.path.join(os.path.dirname(build.__file__),
                           f"{name}.cc"), "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    assert _cached_name(build, name) == f"lib{name}-{tag}.so"


@pytest.mark.parametrize("raw, suffix", [("1", "-san"), ("thread", "-tsan")])
@pytest.mark.parametrize("name", _LIBS)
def test_sanitized_names_match_the_jax_package(monkeypatch, name, raw,
                                               suffix):
    """The same source and flags hash to the same tag in both packages,
    with the mode's suffix, and never to the production name."""
    monkeypatch.delenv("RAY_TPU_NATIVE_SANITIZE", raising=False)
    plain = _cached_name(build, name)
    monkeypatch.setenv("RAY_TPU_NATIVE_SANITIZE", raw)
    port = _cached_name(build, name)
    assert port == _cached_name(jax_build, name)
    assert port.endswith(f"{suffix}.so") and port != plain


def test_sanitized_build_passes_the_mode_flags(monkeypatch, tmp_path):
    """A stale sanitized library is compiled with the mode's flags; the
    production build with none of them."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "_BUILD", str(tmp_path))
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    for raw, flags in (("", []), ("1", build._ASAN_FLAGS),
                       ("thread", build._TSAN_FLAGS)):
        monkeypatch.setenv("RAY_TPU_NATIVE_SANITIZE", raw)
        build.lib_path("fastpath")
        got = [f for f in cmds[-1] if f.startswith("-fsanitize")
               or f.startswith("-fno-")]
        assert got == flags, (raw, cmds[-1])


# ---------------------------------------------------------------------------
# slow: the suites that drive the libraries, under ASan+UBSan
# ---------------------------------------------------------------------------

def _libstdcxx() -> str:
    out = subprocess.run(["g++", "-print-file-name=libstdc++.so.6"],
                         capture_output=True, text=True).stdout.strip()
    return os.path.realpath(out) if os.path.sep in out else ""


def _sanitize_env() -> dict:
    env = dict(os.environ)
    env["RAY_TPU_NATIVE_SANITIZE"] = "1"
    # libstdc++ after libasan: CPython links no libstdc++, so without it
    # the runtime finds no __cxa_throw to forward to and aborts on the
    # first C++ exception any library throws (jaxlib's, in the JAX
    # cluster that test_torch_collective holds the port's groups to)
    env["LD_PRELOAD"] = " ".join(
        p for p in (build.sanitizer_preload(), _libstdcxx()) if p)
    env["JAX_PLATFORMS"] = "cpu"
    # leak checking off, as in tests/test_sanitize.py: CPython, torch and
    # jax hold allocations for the process lifetime; the point is heap
    # corruption and UB in the port's C++, not leaks
    env["ASAN_OPTIONS"] = (
        "detect_leaks=0:abort_on_error=1:verify_asan_link_order=0")
    env["UBSAN_OPTIONS"] = "halt_on_error=1:print_stacktrace=1"
    return env


@pytest.mark.slow
@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")
@pytest.mark.skipif(not build.sanitizer_preload(),
                    reason="libasan runtime not installed")
def test_port_native_surface_under_asan_ubsan():
    """Build the port's three libraries instrumented, then run the suites
    that load them: the compiled DAG's ShmChannel (test_torch_dag), the
    store and the task fast path through a cluster (test_torch_runtime),
    and the collective groups, whose host data crosses ShmChannel rings
    (test_torch_collective)."""
    env = _sanitize_env()
    probe = subprocess.run(
        [sys.executable, "-c",
         "from ray_tpu_torch.native import build;"
         "[build.lib_path(n) for n in ('shm_store', 'shm_channel',"
         " 'fastpath')];"
         "print('built')"],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=300,
    )
    assert probe.returncode == 0, (
        f"sanitized build/load failed:\n{probe.stdout}\n{probe.stderr[-4000:]}")
    assert "built" in probe.stdout

    proc = subprocess.run(
        [sys.executable, "-m", "pytest",
         "tests/test_torch_dag.py", "tests/test_torch_runtime.py",
         "tests/test_torch_collective.py",
         "-q", "-p", "no:cacheprovider", "-m", "not slow"],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=1500,
    )
    tail = (proc.stdout + "\n" + proc.stderr)[-6000:]
    assert proc.returncode == 0, f"sanitized unit run failed:\n{tail}"
    for marker in _SANITIZER_MARKERS:
        assert marker not in proc.stdout and marker not in proc.stderr, (
            f"sanitizer diagnostic in output:\n{tail}")
