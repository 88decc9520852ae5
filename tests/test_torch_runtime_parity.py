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


# -- fractional accelerator leases: num_tpus on JAX's, num_gpus on the port's


def _fractional(rt, opt, res, env) -> dict:
    """Half and one-and-a-half accelerator requests on a node of 2: what
    each binds (the ids in the worker's visibility variable, "" for the
    node's own), the float accounting, a fifth half that waits until one
    of four is killed, and a bundle of two halves."""
    rt.init(num_cpus=4, resources={res: 2})
    out = {}
    try:
        @rt.remote(num_cpus=0)
        def visible():
            return os.environ.get(env, "")

        @rt.remote
        class Reader:
            def visible(self):
                return os.environ.get(env, "")

        out["half_task"] = rt.get(
            visible.options(**{opt: 0.5}).remote(), timeout=60)
        ids = rt.get(visible.options(resources={res: 1.5}).remote(),
                     timeout=60)
        out["one_and_half_task_ids"] = len(ids.split(","))
        half = Reader.options(num_cpus=0, **{opt: 0.5})
        readers = [half.remote() for _ in range(4)]
        out["half_actors"] = rt.get([r.visible.remote() for r in readers],
                                    timeout=60)
        out["available_after_four"] = rt.available_resources().get(res, 0.0)
        fifth = half.remote()
        pending = fifth.visible.remote()
        out["fifth_waits"] = rt.wait([pending], timeout=1)[0] == []
        rt.kill(readers[0])
        out["fifth_after_kill"] = rt.get(pending, timeout=60)
        for r in readers[1:] + [fifth]:
            rt.kill(r)
        from importlib import import_module

        pgs = import_module(f"{rt.__name__}.util.placement_group")
        pg = pgs.placement_group([{res: 0.5}, {res: 0.5}])
        out["half_bundles_ready"] = pg.ready(timeout=60)
        pgs.remove_placement_group(pg)
    finally:
        rt.shutdown()
    return out


def test_fractional_leases_match_jax():
    """``num_gpus=0.5`` on the port behaves as ``num_tpus=0.5`` on JAX's
    runtime: accounted in floats, ``int(n)`` devices bound."""
    jax_out = _fractional(ray_tpu, "num_tpus", "TPU", "TPU_VISIBLE_CHIPS")
    port_out = _fractional(ray_tpu_torch, "num_gpus", "GPU",
                           "CUDA_VISIBLE_DEVICES")
    assert port_out == jax_out
    assert port_out == {
        "half_task": "", "one_and_half_task_ids": 1,
        "half_actors": [""] * 4, "available_after_four": 0.0,
        "fifth_waits": True, "fifth_after_kill": "",
        "half_bundles_ready": True}
