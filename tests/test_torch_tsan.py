"""ThreadSanitizer story for the port's lock-free native plane
(``ray_tpu_torch/native``), mirroring the JAX package's tests/test_tsan.py.

Three layers:

  * a fast audit (tier-1): every `memory_order_relaxed` in fastpath.cc /
    shm_channel.cc / shm_store.cc must sit under a `// tsan:` comment
    justifying why relaxed is safe — the ordering argument lives next to
    the code, and this test keeps it from rotting;
  * a fast identity check (tier-1): the three files are byte-identical to
    ``ray_tpu/native``'s, and both packages build them with the same flags
    (tests/test_torch_sanitize.py), so the JAX package's ``ring`` and
    ``chan_close`` amplifiers (tests/test_tsan.py) run this very code;
  * a slow race amplifier for the one structure the port drives through
    code of its own, ``ShmObjectStore``: creators / pinning readers /
    deleters / stats pollers on a deliberately tiny store with destructive
    eviction on, so pin/release races the LRU reaping path. It runs in a
    child interpreter built with RAY_TPU_NATIVE_SANITIZE=thread and
    LD_PRELOADed libtsan (``python tests/test_torch_tsan.py`` in the
    child). ctypes calls release the GIL, so the threads interleave for
    real inside the instrumented C++. Any data race aborts the child
    (halt_on_error) and fails the assertion here.
"""

import os
import shutil
import subprocess
import sys
import threading
import time

import pytest

from ray_tpu_torch.native import build

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_REPO, "ray_tpu_torch", "native")
_JAX_NATIVE = os.path.join(_REPO, "ray_tpu", "native")
_CC_FILES = ("fastpath.cc", "shm_channel.cc", "shm_store.cc")


# ---------------------------------------------------------------------------
# fast: the `// tsan:` audit must cover every relaxed site
# ---------------------------------------------------------------------------

def test_every_relaxed_site_has_a_tsan_audit_comment():
    """Each memory_order_relaxed is a claim that no synchronization edge is
    needed there. The claim must be written down within the 8 lines above
    the load/store, as a `// tsan:` comment, or this fails."""
    undocumented = []
    for name in _CC_FILES:
        path = os.path.join(_NATIVE, name)
        lines = open(path).read().splitlines()
        for i, line in enumerate(lines):
            if "memory_order_relaxed" not in line:
                continue
            window = lines[max(0, i - 8):i + 1]
            if not any("tsan:" in w for w in window):
                undocumented.append(f"{name}:{i + 1}: {line.strip()}")
    assert undocumented == [], (
        "relaxed atomics without a // tsan: justification:\n"
        + "\n".join(undocumented))


def test_every_native_file_carries_a_tsan_audit():
    """shm_store.cc has no relaxed sites but its single atomic still gets an
    ordering note; all three files must participate in the audit."""
    for name in _CC_FILES:
        src = open(os.path.join(_NATIVE, name)).read()
        assert "tsan:" in src, f"{name} has no // tsan: audit comments"


@pytest.mark.parametrize("name", _CC_FILES)
def test_native_file_is_the_jax_packages(name):
    """The JAX package's tests/test_tsan.py amplifies races in these files;
    that covers the port only while the sources stay the same bytes."""
    with open(os.path.join(_NATIVE, name), "rb") as f:
        port = f.read()
    with open(os.path.join(_JAX_NATIVE, name), "rb") as f:
        jax_src = f.read()
    assert port == jax_src, f"{name} differs from ray_tpu/native/{name}"


# ---------------------------------------------------------------------------
# slow: the store's race amplifier in a TSan-instrumented child
# ---------------------------------------------------------------------------

def _tsan_env() -> dict:
    env = dict(os.environ)
    env["RAY_TPU_NATIVE_SANITIZE"] = "thread"
    env["LD_PRELOAD"] = build.sanitizer_preload("thread")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _REPO  # the child runs this file as a script
    # halt on the first report: the amplifier loops would otherwise bury it;
    # CPython itself is uninstrumented, so reports can only come from our
    # .so code (plus intercepted memcpy/malloc on its behalf).
    env["TSAN_OPTIONS"] = (
        "halt_on_error=1:abort_on_error=1:report_signal_unsafe=0:"
        "history_size=7")
    return env


@pytest.mark.slow
@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")
@pytest.mark.skipif(not build.sanitizer_preload("thread"),
                    reason="libtsan runtime not installed")
def test_store_race_amplifier_clean_under_tsan():
    proc = subprocess.run(
        [sys.executable, os.path.join("tests", "test_torch_tsan.py")],
        env=_tsan_env(), cwd=_REPO, capture_output=True, text=True,
        timeout=600,
    )
    tail = (proc.stdout + "\n" + proc.stderr)[-6000:]
    assert proc.returncode == 0, f"store amplifier failed:\n{tail}"
    assert "SCENARIO-OK" in proc.stdout, tail
    assert "ThreadSanitizer" not in proc.stdout, tail
    assert "ThreadSanitizer" not in proc.stderr, tail


# ---------------------------------------------------------------------------
# child side (this module is re-run as a script inside the TSan env)
# ---------------------------------------------------------------------------

def _scenario_store():
    """Pin/release vs. the destructive-eviction reaper on a tiny store:
    creators churn short-lived objects through a store sized so allocation
    routinely triggers the LRU walk, while readers pin/unpin a shared
    working set, a deleter removes and re-puts, and pollers read stats
    (the lock-free seal_seq) the whole time."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch.runtime.object_store import (
        ObjectStoreFullError, ShmObjectStore)

    name = f"rt-tsan-{os.getpid()}"
    store = ShmObjectStore(name, create=True, size=256 * 1024, capacity=128,
                           allow_evict=True)
    try:
        shared = [ObjectID(bytes([i + 1]) * 24) for i in range(8)]
        for oid in shared:
            store.put_bytes(oid, b"s" * 1024)
        stop = threading.Event()
        errors = []

        def run(fn):
            try:
                while not stop.is_set():
                    fn()
            except Exception as e:  # noqa: BLE001 — surfaced to the parent
                errors.append(repr(e))

        counters = {"created": 0, "pinned": 0}

        def creator_fn(worker=[0]):
            worker[0] += 1
            oid = ObjectID(os.urandom(24))
            try:
                view = store.create(oid, 8 * 1024)
            except (ObjectStoreFullError, FileExistsError):
                return
            view[:] = b"c" * (8 * 1024)
            view.release()
            store.seal(oid)
            store.delete(oid)
            counters["created"] += 1

        def getter_fn(i=[0]):
            oid = shared[i[0] % len(shared)]
            i[0] += 1
            got = store.get(oid)
            if got is None:
                return  # evicted by a full creator — legal here
            view, _meta = got
            assert view[:1] in (b"s", b"r")
            view.release()
            store.release(oid)
            counters["pinned"] += 1

        def deleter_fn(i=[0]):
            oid = shared[i[0] % len(shared)]
            i[0] += 1
            if store.delete(oid):
                try:
                    store.put_bytes(oid, b"r" * 1024)
                except (ObjectStoreFullError, FileExistsError):
                    pass

        def poller_fn():
            store.stats()

        threads = [threading.Thread(target=run, args=(f,))
                   for f in (creator_fn, creator_fn, getter_fn, getter_fn,
                             deleter_fn, poller_fn)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
        assert errors == [], errors
        assert counters["created"] > 0 and counters["pinned"] > 0, counters
    finally:
        store.destroy()


if __name__ == "__main__":
    _scenario_store()
    print("SCENARIO-OK")
