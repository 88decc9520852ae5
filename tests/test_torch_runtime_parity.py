"""One deterministic program of tasks, nested tasks, multiple returns, ref
arguments, an actor with state, a restart after a kill, ``wait`` splits
and a raised error, run on ``ray_tpu`` and then on ``ray_tpu_torch``, each
in a cluster of its own (``init`` ... ``shutdown``). Every result must be
equal: values, exception types and messages, ready / not-ready splits and
restart counts. Both runtimes run in the pytest worker; neither imports
torch."""

import os
import time

import pytest

import ray_tpu
import ray_tpu_torch


def _restarts(rt, handle) -> int:
    cw = rt.get_core_worker()
    reply = cw.run_sync(cw.control.call(
        "get_actor_info", {"actor_id": handle._actor_id.binary()}))
    return reply["actor"]["num_restarts"]


def _program(rt) -> dict:
    out = {}

    @rt.remote
    def sq(x):
        return x * x

    @rt.remote
    def outer(x):
        return rt.get(sq.remote(x), timeout=30) + 1

    @rt.remote(num_returns=2)
    def pair(x):
        return x, -x

    @rt.remote
    def plus(a, b):
        return a + b

    out["tasks"] = rt.get([sq.remote(i) for i in range(8)], timeout=60)
    out["nested"] = rt.get(outer.remote(7), timeout=60)
    out["returns"] = rt.get(list(pair.remote(3)), timeout=30)
    x = rt.put(5)
    out["ref_args"] = rt.get(plus.remote(plus.remote(x, 6), x), timeout=30)

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def pid(self):
            return os.getpid()

    c = Counter.options(max_restarts=1).remote()
    out["actor"] = rt.get([c.inc.remote() for _ in range(3)], timeout=60)
    pid = rt.get(c.pid.remote(), timeout=30)
    rt.kill(c, no_restart=False)
    deadline = time.monotonic() + 60
    while True:  # a call racing the death report may fail: retry
        try:
            new_pid = rt.get(c.pid.remote(), timeout=60)
            if new_pid != pid:
                break
        except (rt.ActorUnavailableError, rt.ActorDiedError):
            pass
        assert time.monotonic() < deadline, "the actor never restarted"
        time.sleep(0.1)
    out["after_restart"] = rt.get([c.inc.remote() for _ in range(2)],
                                  timeout=30)
    out["restarts"] = _restarts(rt, c)
    rt.kill(c)

    @rt.remote
    def nap(s):
        time.sleep(s)
        return s

    refs = [nap.remote(0), nap.remote(1.0), nap.remote(0)]
    ready, not_ready = rt.wait(refs, num_returns=2, timeout=10)
    out["wait"] = (sorted(refs.index(r) for r in ready),
                   [refs.index(r) for r in not_ready])
    out["wait_all"] = [len(p) for p in rt.wait(refs, num_returns=3,
                                               timeout=10)]

    @rt.remote
    def boom():
        raise ValueError("boom 42")

    try:
        rt.get(boom.remote(), timeout=30)
        out["error"] = None
    except rt.TaskError as e:
        out["error"] = (type(e).__name__, e.function_name,
                        type(e.__cause__).__name__, str(e.__cause__))
    return out


def _run(rt) -> dict:
    rt.init(num_cpus=4)
    try:
        return _program(rt)
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def results():
    return {"jax": _run(ray_tpu), "port": _run(ray_tpu_torch)}


@pytest.mark.parametrize("key", ["tasks", "nested", "returns", "ref_args",
                                 "actor", "after_restart", "restarts",
                                 "wait", "wait_all", "error"])
def test_port_runtime_matches_jax(results, key):
    assert results["port"][key] == results["jax"][key]
    assert results["jax"][key] is not None


def test_program_results_are_the_expected_ones(results):
    """Both runtimes agree, and on the right answers."""
    assert results["port"] == {
        "tasks": [i * i for i in range(8)], "nested": 50, "returns": [3, -3],
        "ref_args": 16, "actor": [1, 2, 3], "after_restart": [1, 2],
        "restarts": 1, "wait": ([0, 2], [1]), "wait_all": [3, 0],
        "error": ("TaskError", "_program.<locals>.boom", "ValueError",
                  "boom 42")}
