"""The port's own task and actor runtime (``ray_tpu_torch.init``: its control
store, node daemon and workers) against the cases of ``test_core_api.py``,
the GPU lease accounting of ``test_round2_fixes.py`` / ``test_cluster.py``
with TPU chips read as CUDA devices, and the reference counter's finaliser
repair.

The runtime imports no torch, so these tests run in the pytest worker (the
rest of the port's tests keep torch in a spawned child, ``_port_proc``).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.util.metrics import reset_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    info = rt.init(num_cpus=4, resources={"GPU": 2})
    yield info
    rt.shutdown()


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The conftest fixture resets the JAX package's registries; this one
    resets the port's."""
    yield
    GLOBAL_CONFIG.reset()
    chaos.reset()
    reset_registry()


# -- tasks -------------------------------------------------------------------


def _basic():
    @rt.remote
    def f(a, b=10):
        return a + b

    return [rt.get(f.remote(1), timeout=30),
            rt.get(f.remote(1, b=2), timeout=30)], [11, 3]


def _parallel():
    @rt.remote
    def sq(x):
        return x * x

    return (rt.get([sq.remote(i) for i in range(50)], timeout=60),
            [i * i for i in range(50)])


def _multiple_returns():
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    return rt.get(list(three.remote()), timeout=30), [1, 2, 3]


def _nested():
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x), timeout=30) + 1

    return rt.get(outer.remote(5), timeout=60), 11


def _ref_kwargs():
    @rt.remote
    def plus(a, b=0):
        return a + b

    x = rt.put(5)
    return [rt.get(plus.remote(1, b=x), timeout=30),
            rt.get(plus.remote(a=x, b=x), timeout=30)], [6, 10]


def _ref_args():
    @rt.remote
    def plus(a, b):
        return a + b

    x = rt.put(5)
    return rt.get(plus.remote(plus.remote(x, 6), x), timeout=30), 16


def _large_arg():
    arr = np.arange(500_000, dtype=np.float32)

    @rt.remote
    def double(a):
        return a * 2

    out = rt.get(double.remote(arr), timeout=30)
    return out[:10].tolist(), (arr[:10] * 2).tolist()


@pytest.mark.parametrize("case", [_basic, _parallel, _multiple_returns,
                                  _nested, _ref_kwargs, _ref_args,
                                  _large_arg],
                         ids=lambda c: c.__name__.strip("_"))
def test_task(cluster, case):
    got, want = case()
    assert got == want


def test_task_error_propagation(cluster):
    @rt.remote
    def boom():
        raise ValueError("boom!")

    with pytest.raises(rt.TaskError) as exc_info:
        rt.get(boom.remote(), timeout=30)
    assert "boom!" in str(exc_info.value)
    assert isinstance(exc_info.value.__cause__, ValueError)


@pytest.mark.parametrize("value", [42, "hello", {"k": [1, 2, 3]},
                                   np.ones((100, 100))],
                         ids=["int", "str", "dict", "array"])
def test_put_get_roundtrip(cluster, value):
    out = rt.get(rt.put(value), timeout=30)
    if isinstance(value, np.ndarray):
        np.testing.assert_array_equal(out, value)
    else:
        assert out == value


def test_wait(cluster):
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(1.5)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=10)
    assert ready == [f] and not_ready == [s]
    ready2, not_ready2 = rt.wait([f, s], num_returns=2, timeout=10)
    assert set(ready2) == {f, s} and not not_ready2


def test_get_timeout_and_cancel(cluster):
    @rt.remote
    def hang():
        time.sleep(30)

    ref = hang.remote()
    with pytest.raises(rt.GetTimeoutError):
        rt.get(ref, timeout=0.5)
    assert rt.cancel(ref, force=True)
    with pytest.raises((rt.TaskCancelledError, rt.WorkerCrashedError)):
        rt.get(ref, timeout=30)


def test_many_ref_args_resolve_batched(cluster):
    """2000 driver-owned refs resolve on the executor in batches, mixed
    with inline values and an error ref. No wall-clock bound: the JAX
    test's 10 s limit fails under load."""

    @rt.remote
    def consume(*parts):
        return sum(p for p in parts if isinstance(p, int))

    n = 2000
    refs = [rt.put(i) for i in range(n)]
    assert rt.get(consume.remote(*refs, 1000), timeout=300) == (
        n * (n - 1) // 2 + 1000)

    @rt.remote
    def boom():
        raise ValueError("arg exploded")

    with pytest.raises(rt.TaskError, match="arg exploded"):
        rt.get(consume.remote(refs[0], boom.remote()), timeout=120)


# -- actors ------------------------------------------------------------------


def _dead_or_unavailable(call):
    with pytest.raises((rt.ActorDiedError, rt.ActorUnavailableError)):
        rt.get(call, timeout=60)


def test_actor_basic(cluster):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def value(self):
            return self.n

    c = Counter.remote(start=10)
    assert rt.get([c.inc.remote() for _ in range(5)], timeout=60) == [
        11, 12, 13, 14, 15]  # ordered execution
    assert rt.get(c.value.remote(), timeout=30) == 15
    rt.kill(c)


@pytest.mark.parametrize("where", ["init", "method"])
def test_actor_errors(cluster, where):
    @rt.remote
    class A:
        def __init__(self, fail):
            if fail:
                raise RuntimeError("bad init")

        def boom(self):
            raise KeyError("nope")

        def ok(self):
            return "ok"

    a = A.remote(where == "init")
    if where == "init":
        _dead_or_unavailable(a.ok.remote())
        return
    with pytest.raises(rt.TaskError):
        rt.get(a.boom.remote(), timeout=30)
    assert rt.get(a.ok.remote(), timeout=30) == "ok"  # survives the error
    rt.kill(a)


def test_actor_handle_in_task(cluster):
    @rt.remote
    class Store:
        def __init__(self):
            self.v = {}

        def put(self, k, v):
            self.v[k] = v
            return True

        def get(self, k):
            return self.v.get(k)

    @rt.remote
    def writer(store, k, v):
        return rt.get(store.put.remote(k, v), timeout=30)

    s = Store.remote()
    assert rt.get(writer.remote(s, "a", 1), timeout=60)
    assert rt.get(s.get.remote("a"), timeout=30) == 1
    rt.kill(s)


def test_async_actor(cluster):
    @rt.remote
    class AsyncWorker:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.05)
            return x * 2

    w = AsyncWorker.remote()
    assert rt.get([w.work.remote(i) for i in range(10)], timeout=60) == [
        i * 2 for i in range(10)]
    rt.kill(w)


def test_named_actor_and_kill(cluster):
    @rt.remote
    class Named:
        def ping(self):
            return "pong"

    Named.options(name="the-named-one").remote()
    h = rt.get_actor("the-named-one")
    assert rt.get(h.ping.remote(), timeout=60) == "pong"
    rt.kill(h)
    _dead_or_unavailable(h.ping.remote())
    with pytest.raises(ValueError):
        rt.get_actor("the-named-one")


def test_actor_restart(cluster):
    @rt.remote
    class Phoenix:
        def pid(self):
            return os.getpid()

        def die(self):
            os._exit(1)

    # max_task_retries=0: `die` is not re-run on the restarted actor
    p = Phoenix.options(max_restarts=1, max_task_retries=0).remote()
    pid1 = rt.get(p.pid.remote(), timeout=60)
    p.die.remote()
    deadline = time.time() + 90
    while True:
        try:
            pid2 = rt.get(p.pid.remote(), timeout=90)
            break
        except rt.ActorUnavailableError:
            assert time.time() < deadline, "actor never came back"
            time.sleep(0.5)
    assert pid2 != pid1
    rt.kill(p)


@pytest.mark.parametrize("how", ["dropped", "in_a_cycle"])
def test_actor_dies_with_its_last_handle(cluster, how):
    """An actor goes when its last handle does, also when the cyclic GC
    frees that handle (the JAX package's handle, holding its owner by a
    weakref that the collector clears first, leaks the actor then)."""
    import gc

    @rt.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    assert rt.get(a.ping.remote(), timeout=60) == 1
    aid = a._actor_id.binary()
    if how == "in_a_cycle":
        node = {"handle": a}
        node["self"] = node
        del node
    del a
    gc.collect()
    cw = rt.get_core_worker()
    deadline = time.monotonic() + 30
    while cw.run_sync(cw.control.call("get_actor_info", {"actor_id": aid}),
                      30)["actor"]["state"] != "DEAD":
        assert time.monotonic() < deadline, "the actor outlived its handle"
        time.sleep(0.05)


def test_cluster_resources(cluster):
    total = rt.cluster_resources()
    assert total.get("CPU") == 4.0 and total.get("GPU") == 2.0
    assert len(rt.nodes()) == 1


# -- GPU leases (TPU chips read as CUDA devices) -----------------------------


def _visible_reader():
    @rt.remote
    class Reader:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES", "")

    return Reader


def test_gpu_leases_are_disjoint_and_queue(cluster):
    """Two 1-GPU actors see disjoint devices; a third waits while they
    hold both and starts once one is killed, on the freed device."""
    Reader = _visible_reader()
    a = Reader.options(num_gpus=1).remote()
    b = Reader.options(num_gpus=1).remote()
    va = rt.get(a.visible.remote(), timeout=60)
    vb = rt.get(b.visible.remote(), timeout=60)
    assert {va, vb} == {"0", "1"}, (va, vb)
    c = Reader.options(num_gpus=1).remote()
    pending = c.visible.remote()
    ready, not_ready = rt.wait([pending], timeout=1)
    assert not ready and not_ready == [pending]
    rt.kill(a)
    assert rt.get(pending, timeout=60) == va
    rt.kill(b)
    rt.kill(c)


def test_gpu_devices_return_after_kill(cluster):
    Reader = _visible_reader()
    a = Reader.options(num_gpus=2).remote()
    # every device granted: the env is left as it was
    assert rt.get(a.visible.remote(), timeout=60) == ""
    rt.kill(a)
    b = Reader.options(num_gpus=1).remote()
    assert rt.get(b.visible.remote(), timeout=60) in ("0", "1")
    rt.kill(b)


def test_gpu_task_lease(cluster):
    @rt.remote(num_gpus=1)
    def visible():
        return os.environ.get("CUDA_VISIBLE_DEVICES", "")

    # each lease gets a fresh worker bound to one device of the two
    got = rt.get([visible.remote() for _ in range(3)], timeout=60)
    assert set(got) <= {"0", "1"}, got


def test_pg_num_gpus_request_gets_no_implicit_cpu():
    from ray_tpu_torch.remote_function import build_resources

    pg = object()
    assert build_resources({"num_gpus": 4, "placement_group": pg}) == {
        "GPU": 4.0}
    assert build_resources({"num_gpus": 4}) == {"GPU": 4.0, "CPU": 1.0}
    assert build_resources(
        {"num_gpus": 4, "num_cpus": 2, "placement_group": pg}
    ) == {"GPU": 4.0, "CPU": 2.0}


def test_set_visible_devices_env():
    from ray_tpu_torch.gpu.accelerator import GpuAcceleratorManager as M

    env = {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}
    M.set_visible_devices_env(env, [0, 1, 2, 3], 4)
    assert env == {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}  # all: left as it was
    env = {}
    M.set_visible_devices_env(env, [2, 3], 4)
    assert env == {"CUDA_VISIBLE_DEVICES": "2,3"}


@pytest.mark.parametrize("how", ["num_gpus", "resources"])
def test_fractional_gpu_request_is_refused(cluster, how):
    """No longer refused (the name is kept): a fractional GPU request is
    accounted in floats and binds ``int(n)`` devices, as the JAX package's
    ``num_tpus`` does (``test_torch_runtime_parity.py`` runs one program on
    both). ``num_gpus=0.5`` binds none: the task and the actor keep the
    node's visibility; ``GPU: 1.5`` binds one device of the two."""
    Reader = _visible_reader()
    frac = 0.5 if how == "num_gpus" else 1.5
    opts = ({"num_gpus": 0.5} if how == "num_gpus"
            else {"resources": {"GPU": 1.5}})
    want = {""} if frac < 1 else {"0", "1"}

    @rt.remote
    def f():
        return os.environ.get("CUDA_VISIBLE_DEVICES", "")

    assert rt.get(f.options(**opts).remote(), timeout=60) in want
    a = Reader.options(**opts).remote()
    assert rt.get(a.visible.remote(), timeout=60) in want
    _wait_available_gpus(2.0 - frac)  # the task's lease returns
    rt.kill(a)
    _wait_available_gpus(2.0)


def _wait_available_gpus(n: float, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while rt.available_resources().get("GPU") != n:
        assert time.monotonic() < deadline, (n, rt.available_resources())
        time.sleep(0.1)


def test_gpu_visible_devices_restricts_every_worker():
    """``gpu_visible_devices`` keeps the devices it names (here two of
    three that ``gpus_per_host`` makes on a host with none): the node
    advertises two, a worker granted both sees both, a 1-GPU worker one of
    them and a CPU worker the same two."""
    code = (
        "import os\n"
        "import ray_tpu_torch as rt\n"
        "rt.init(num_cpus=2, system_config={'gpus_per_host': 3,\n"
        "        'gpu_visible_devices': '1,2'})\n"
        "assert rt.cluster_resources()['GPU'] == 2.0\n"
        "@rt.remote\n"
        "def visible():\n"
        "    return os.environ.get('CUDA_VISIBLE_DEVICES', '')\n"
        "both = rt.get(visible.options(num_gpus=2).remote(), timeout=60)\n"
        "one = rt.get(visible.options(num_gpus=1).remote(), timeout=60)\n"
        "cpu = rt.get(visible.remote(), timeout=60)\n"
        "rt.shutdown()\n"
        "print('seen', both, one, cpu)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["RT_GPU_AUTODETECT"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    _, both, one, cpu = out.stdout.split()
    assert both == "1,2" and one in ("1", "2") and cpu == "1,2", out.stdout


def test_gpu_detection_flags(monkeypatch):
    """With no device found, ``gpus_per_host`` alone makes the node's
    devices; ``gpu_visible_devices`` keeps those it names and refuses an
    id that is not there; CUDA_VISIBLE_DEVICES narrows what detection
    found."""
    from ray_tpu_torch.gpu import accelerator as acc

    monkeypatch.setattr(acc, "_nvidia_smi", lambda: [])
    monkeypatch.setattr(acc, "_proc_gpus", lambda: [])
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert acc.GpuAcceleratorManager.detect(allow_cuda_probe=False) is None
    GLOBAL_CONFIG.apply_system_config({"gpus_per_host": 2})
    info = acc.GpuAcceleratorManager.detect(allow_cuda_probe=False)
    assert info.device_ids == [0, 1]
    import socket

    assert acc.GpuAcceleratorManager.node_resources_and_labels(info) == (
        {"GPU": 2.0, "GPU-gpu-2-head": 1.0},
        {"gpu-count": "2", "gpu-pod-type": "gpu-2",
         "gpu-domain-name": f"gpu-2-{socket.gethostname()}-0-1",
         "gpu-worker-id": "0", "gpu-topology": "1x2", "rt.gpu.coord": "0,0"})
    GLOBAL_CONFIG.apply_system_config({"gpu_visible_devices": "1"})
    assert acc.GpuAcceleratorManager.detect(
        allow_cuda_probe=False).device_ids == [1]
    GLOBAL_CONFIG.apply_system_config({"gpu_visible_devices": "1,2"})
    with pytest.raises(ValueError, match=r"names \[2\]"):
        acc.GpuAcceleratorManager.detect(allow_cuda_probe=False)
    GLOBAL_CONFIG.reset()
    devs = [(0, "NVIDIA H100 80GB HBM3", "GPU-aa"),
            (1, "NVIDIA H100 80GB HBM3", "GPU-bb")]
    monkeypatch.setattr(acc, "_nvidia_smi", lambda: devs)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-bb")
    info = acc.GpuAcceleratorManager.detect(allow_cuda_probe=False)
    assert info.device_ids == [1] and info.name == "NVIDIA H100 80GB HBM3"
    assert acc.GpuAcceleratorManager.node_resources_and_labels(info)[1][
        "gpu-name"] == "NVIDIA H100 80GB HBM3"


# -- the reference counter's finaliser repair --------------------------------


@pytest.mark.parametrize("where", ["gc_in_binary", "gc_under_lock",
                                   "handle_gc_under_lock"])
def test_finaliser_never_blocks_reference_counter(where):
    """The JAX package's ReferenceCounter deadlocks when the cyclic GC runs
    an ``ObjectRef.__del__`` inside ``add_local`` (which calls
    ``ref.binary()`` under its lock). ``_port_refcount_probe`` runs the GC
    (a) inside a ``binary()`` that ``add_local`` calls, (b) while the thread
    holds the counter's lock, (c) while it holds the core worker's lock
    (an owned ActorHandle's finaliser), each on a thread joined with a
    timeout, in a process of its own: each must finish and release what
    the cycle held."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_port_refcount_probe.py"),
         where], env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", (
        out.stdout + out.stderr)


# -- imports -----------------------------------------------------------------


def test_cluster_run_imports_no_torch_jax_or_ray_tpu():
    """A fresh interpreter: import, start a cluster, run one task, shut it
    down; neither torch nor JAX nor the JAX package was imported."""
    code = (
        "import sys\n"
        "import ray_tpu_torch as rt\n"
        "rt.init(num_cpus=1)\n"
        "f = rt.remote(lambda x: x + 1)\n"
        "assert rt.get(f.remote(1), timeout=60) == 2\n"
        "rt.shutdown()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('torch', 'jax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
