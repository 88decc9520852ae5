"""The port's serve library held to the JAX package's.

- The autoscaling plane's pure functions (``AutoscalingPolicy``,
  ``replica_load``, ``replica_shape``, ``count_placeable``,
  ``demand_shapes``): the cases of ``test_serve_autoscaling.py`` run on
  each package's module and must give the same answers (``num_tpus`` /
  ``"TPU"`` there is ``num_gpus`` / ``"GPU"`` here); its cluster case runs
  on the port's cluster.
- ``build_config`` gives the same document in both packages.
- One serve program (a deployment's answers, a user error, HTTP codes, a
  503 shed with its Retry-After and a 504 deadline) runs on a cluster of
  each package, one after the other: every observation must be equal.

Neither package imports torch here, so everything runs in the pytest
worker. The HTTP ingress binds port 0.
"""

import asyncio
import gc
import importlib
import threading
import time

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.util.metrics import reset_registry

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
# the accelerator each package's scheduler maps: option name, resource
ACCELERATOR = {"ray_tpu": ("num_tpus", "TPU"),
               "ray_tpu_torch": ("num_gpus", "GPU")}


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The conftest fixture resets the JAX package's registries; this one
    resets the port's."""
    yield
    GLOBAL_CONFIG.reset()
    chaos.reset()
    reset_registry()


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


def _autoscaling(pkg):
    return importlib.import_module(f"{pkg}.serve._autoscaling")


def _resource_set(pkg):
    return importlib.import_module(f"{pkg}._private.protocol").ResourceSet


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


def _policy(pkg, clock=None, **cfg):
    cfg.setdefault("min_replicas", 1)
    cfg.setdefault("max_replicas", 8)
    cfg.setdefault("target_ongoing_requests", 2)
    cfg.setdefault("upscale_delay_s", 0.0)
    cfg.setdefault("downscale_delay_s", 10.0)
    return _autoscaling(pkg).AutoscalingPolicy(cfg, clock=clock or FakeClock())


def _st(ongoing=0, queued=0, peak_ongoing=0, peak_queued=0, **extra):
    st = dict(ongoing=ongoing, queued=queued, peak_ongoing=peak_ongoing,
              peak_queued=peak_queued)
    st.update(extra)
    return st


# -- demand (test_serve_autoscaling.py) --------------------------------------


def test_replica_load_uses_peak_of_window(pkg):
    replica_load = _autoscaling(pkg).replica_load
    # a burst that queued and drained entirely between probes still counts
    assert replica_load(_st(ongoing=1, queued=0,
                            peak_ongoing=4, peak_queued=6)) == 10.0
    assert replica_load(_st(ongoing=3, queued=2)) == 5.0


def test_scale_up_on_queue_depth(pkg):
    p = _policy(pkg)
    # 2 replicas, 8 in-flight + 8 queued, target 2/replica -> 8 replicas
    stats = [_st(ongoing=4, queued=4), _st(ongoing=4, queued=4)]
    assert p.desired_from_stats(stats, running=2) == 8


def test_probe_blackout_holds_current_fleet(pkg):
    # every probe failed: hold, never invent a scale-to-min
    assert _policy(pkg).desired_from_stats([], running=5) == 5


def test_ttft_signal_scales_proportionally(pkg):
    p = _policy(pkg, target_ttft_s=0.5)
    # light queue load, but the WORST replica's TTFT is 3x over target
    stats = [_st(ongoing=1, ttft_p50_s=0.1), _st(ongoing=1, ttft_p50_s=1.5)]
    assert p.desired_from_stats(stats, running=2) == 6


def test_tokens_per_s_signal_adds_replicas_when_saturated(pkg):
    p = _policy(pkg, target_tokens_per_s=100)
    # 25 tok/s observed vs 100 target -> 4x the fleet
    assert p.desired_from_stats([_st(ongoing=2, tokens_per_s=25.0)],
                                running=1) == 4


# -- smoothing ---------------------------------------------------------------


def test_upscale_is_immediate_by_default(pkg):
    assert _policy(pkg, clock=FakeClock()).update(6, 2) == 6


def test_upscale_delay_requires_sustained_demand(pkg):
    clk = FakeClock()
    p = _policy(pkg, clock=clk, upscale_delay_s=5.0)
    assert p.update(6, 2) == 2      # demand just appeared: hold
    clk.advance(3.0)
    assert p.update(6, 2) == 2      # still inside the delay
    clk.advance(2.5)
    assert p.update(6, 2) == 6      # sustained past the delay: adopt


def test_downscale_cooldown_hysteresis(pkg):
    clk = FakeClock()
    p = _policy(pkg, clock=clk, downscale_delay_s=10.0)
    assert p.update(1, 4) == 4      # low reading starts the window
    clk.advance(6.0)
    assert p.update(1, 4) == 4      # cooldown not elapsed
    clk.advance(5.0)
    assert p.update(1, 4) == 1      # sustained-low: shrink


def test_downscale_sized_to_window_peak_not_last_sample(pkg):
    """Sawtooth load holds its high-water fleet instead of thrashing."""
    clk = FakeClock()
    p = _policy(pkg, clock=clk, downscale_delay_s=10.0)
    assert p.update(1, 6) == 6
    clk.advance(4.0)
    assert p.update(3, 6) == 6      # mid-window spike (still < current)
    clk.advance(7.0)
    # window elapsed: shrink to the PEAK seen inside it (3), not 1
    assert p.update(1, 6) == 3


def test_demand_spike_resets_downscale_window(pkg):
    clk = FakeClock()
    p = _policy(pkg, clock=clk, downscale_delay_s=10.0)
    assert p.update(1, 4) == 4
    clk.advance(8.0)
    assert p.update(4, 4) == 4      # demand back at target: window resets
    clk.advance(8.0)
    assert p.update(1, 4) == 4      # NEW window just started
    clk.advance(3.0)
    assert p.update(1, 4) == 4      # 3s into the new window: still held
    clk.advance(8.0)
    assert p.update(1, 4) == 1      # 11s sustained-low: shrink


def test_scale_to_zero_guarded_by_min_replicas(pkg):
    clk = FakeClock()
    p = _policy(pkg, clock=clk, min_replicas=1, downscale_delay_s=0.0)
    # idle fleet with min_replicas=1 floors at 1, never 0
    assert p.desired_from_stats([_st()], running=1) == 1
    assert p.update(0, 1) == 1
    # opting in via min_replicas=0 allows reaching zero
    p0 = _policy(pkg, clock=clk, min_replicas=0, downscale_delay_s=0.0)
    assert p0.update(0, 1) == 0


def test_clamp_respects_max_replicas(pkg):
    p = _policy(pkg, max_replicas=4)
    assert p.desired_from_stats([_st(ongoing=50, queued=50)], running=1) == 4
    assert p.update(100, 1) == 4


def test_policy_decisions_equal_case_for_case():
    """One seeded sequence of load readings through both packages'
    policies, with every signal on: the same decision at every tick."""
    import random

    rng = random.Random(7)
    cfg = dict(min_replicas=1, max_replicas=16, target_ongoing_requests=2,
               upscale_delay_s=1.5, downscale_delay_s=4.0,
               target_ttft_s=0.4, target_tokens_per_s=20)
    clocks = {p: FakeClock() for p in PACKAGES}
    policies = {p: _policy(p, clock=clocks[p], **cfg) for p in PACKAGES}
    running = {p: 2 for p in PACKAGES}
    decisions = {p: [] for p in PACKAGES}
    level = 4  # the offered load: a random walk, so the fleet must follow
    for _ in range(300):
        level = min(max(level + rng.choice((-2, -1, 0, 1, 2)), 0), 30)
        stats = [_st(ongoing=rng.randint(0, level), queued=rng.randint(0, 2),
                     peak_ongoing=rng.randint(0, level),
                     ttft_p50_s=rng.uniform(0.0, 0.5),
                     tokens_per_s=rng.uniform(20.0, 120.0))
                 for _ in range(running["ray_tpu"])]
        if rng.random() < 0.05:
            stats = []  # a probe blackout
        dt = rng.uniform(0.0, 1.5)
        for p in PACKAGES:
            desired = policies[p].desired_from_stats(stats, running[p])
            running[p] = policies[p].update(desired, running[p])
            decisions[p].append((desired, running[p]))
            clocks[p].advance(dt)
    assert decisions["ray_tpu_torch"] == decisions["ray_tpu"]
    assert len({r for _, r in decisions["ray_tpu"]}) > 3  # it moved


# -- placement / demand ------------------------------------------------------


def _node(pkg, avail, state="ALIVE"):
    return {"state": state, "available": _resource_set(pkg)(avail).to_wire()}


def test_replica_shape_matches_scheduler_mapping(pkg):
    replica_shape = _autoscaling(pkg).replica_shape
    opt, res = ACCELERATOR[pkg]
    assert replica_shape({"num_cpus": 2}) == {"CPU": 2.0}
    assert replica_shape({opt: 4, "num_cpus": 1}) == {res: 4.0, "CPU": 1.0}
    # the implicit 1-CPU scheduling default applies to replicas too
    assert replica_shape({}) == {"CPU": 1.0}
    # a 1-accelerator replica of each package, as serve apps ask for one
    assert replica_shape({opt: 1}) == {res: 1.0, "CPU": 1.0}


def test_fractional_gpu_replica_is_refused():
    """No longer refused (the name is kept): a replica asking for half a
    GPU has the shape and the packing of the JAX package's half-TPU
    replica: two fit on a node with one device, five on one with 2.5."""
    shapes, fits = {}, {}
    for pkg, (opt, res) in ACCELERATOR.items():
        a = _autoscaling(pkg)
        shape = a.replica_shape({opt: 0.5})
        shapes[pkg] = {k.replace(res, "ACC"): v for k, v in shape.items()}
        fits[pkg] = [a.count_placeable(shape, [_node(pkg, {"CPU": 8,
                                                           res: n})],
                                       pending=8) for n in (1, 2.5)]
    assert shapes["ray_tpu_torch"] == shapes["ray_tpu"] == {
        "ACC": 0.5, "CPU": 1.0}
    assert fits["ray_tpu_torch"] == fits["ray_tpu"] == [2, 5]


def test_count_placeable_first_fit_across_nodes(pkg):
    count_placeable = _autoscaling(pkg).count_placeable
    nodes = [_node(pkg, {"CPU": 2}), _node(pkg, {"CPU": 3})]
    assert count_placeable({"CPU": 1.0}, nodes, pending=10) == 5
    assert count_placeable({"CPU": 2.0}, nodes, pending=10) == 2
    assert count_placeable({"CPU": 4.0}, nodes, pending=10) == 0


def test_count_placeable_skips_dead_nodes_and_zero_pending(pkg):
    count_placeable = _autoscaling(pkg).count_placeable
    nodes = [_node(pkg, {"CPU": 8}, state="DEAD"), _node(pkg, {"CPU": 1})]
    assert count_placeable({"CPU": 1.0}, nodes, pending=3) == 1
    assert count_placeable({"CPU": 1.0}, nodes, pending=0) == 0


def test_demand_published_only_for_unplaceable(pkg):
    """Shapes are published ONLY for replicas that fit nowhere: a node
    with 2 accelerators places 2 of 5 one-accelerator replicas."""
    a = _autoscaling(pkg)
    _, res = ACCELERATOR[pkg]
    shape = {"CPU": 2.0, res: 1.0}
    nodes = [_node(pkg, {"CPU": 4, res: 2})]
    pending = 5
    placeable = a.count_placeable(shape, nodes, pending)
    assert placeable == 2
    shapes = a.demand_shapes(shape, pending - placeable)
    assert shapes == [shape, shape, shape]
    # everything fits -> empty payload (published as a withdrawal)
    assert a.demand_shapes(shape, 0) == []
    assert a.demand_key("llm") == "serve:llm"


def test_replica_peak_counters_reset_on_poll(pkg):
    """peak_queued is peak-SINCE-LAST-POLL like peak_ongoing, so the fleet
    drains back to min_replicas after traffic stops."""
    ServeReplica = importlib.import_module(
        f"{pkg}.serve._replica").ServeReplica

    async def fn(payload=None):
        return payload

    r = ServeReplica._cls("d", 0, cloudpickle.dumps(fn),
                          cloudpickle.dumps(((), {})),
                          max_concurrent=1, max_queued=8)
    r._peak_ongoing = 7
    r._peak_queued = 6
    first = asyncio.run(r.stats())
    assert first["peak_ongoing"] == 7 and first["peak_queued"] == 6
    second = asyncio.run(r.stats())
    assert second["peak_ongoing"] == 0 and second["peak_queued"] == 0
    assert _autoscaling(pkg).replica_load(second) == 0.0


def test_actor_placement_reaches_cursor_readers():
    """The control store's deduction on actor placement lands in the
    availability change log, so a cursor reader (the node autoscaler's
    delta poll) sees it: on the port's cluster."""
    rt = ray_tpu_torch
    rt.init(num_cpus=4)
    try:
        cw = rt.get_core_worker()

        def load(cursor):
            return cw.run_sync(
                cw.control.call("get_cluster_load", {"cursor": cursor}), 10)

        full = load(None)
        cursor = full["version"]
        assert [n["available"] for n in full["nodes"]] == [{"CPU": 40000}]

        @rt.remote(num_cpus=2)
        class Holder:
            def ping(self):
                return 1

        h = Holder.remote()
        assert rt.get(h.ping.remote(), timeout=60) == 1
        deadline = time.time() + 20
        rows = []
        while time.time() < deadline:
            reply = load(cursor)
            assert reply.get("delta") is True
            rows = reply["nodes"]
            if any(n["available"].get("CPU") == 20000 for n in rows):
                break
            time.sleep(0.2)
        assert any(n["available"].get("CPU") == 20000 for n in rows), rows
        rt.kill(h)
    finally:
        rt.shutdown()


# -- build_config ------------------------------------------------------------


def _double(x):
    return 2 * x


def test_build_config_equal_in_both_packages():
    docs = {}
    for p in PACKAGES:
        serve = importlib.import_module(f"{p}.serve")
        opt, _ = ACCELERATOR[p]
        deps = [
            serve.Deployment(_double, "Doubler", num_replicas=3),
            serve.Deployment(
                _double, "Scaled", max_concurrent_queries=7,
                autoscaling_config={"min_replicas": 1, "max_replicas": 4},
                ray_actor_options={"num_cpus": 2, opt: 1},
                max_queued_requests=5, version="v9"),
        ]
        docs[p] = serve.build_config(*deps)
    # the accelerator option is each package's own name
    port, jax_doc = docs["ray_tpu_torch"], docs["ray_tpu"]
    opts = port["applications"][1]["ray_actor_options"]
    opts["num_tpus"] = opts.pop("num_gpus")
    assert port == jax_doc
    assert [a["name"] for a in jax_doc["applications"]] == ["Doubler",
                                                           "Scaled"]


# -- one serve program on a cluster of each package --------------------------


def _program(rt, serve) -> dict:
    import httpx

    out = {}
    GLOBAL = importlib.import_module(
        f"{rt.__name__}._private.config").GLOBAL_CONFIG
    # handle failover off, so the replica's own refusals surface
    GLOBAL.apply_system_config({"serve_retry_budget_min": 0,
                                "serve_retry_budget_ratio": 0.0})

    @serve.deployment(num_replicas=2, name="Calc")
    class Calc:
        def __init__(self, base):
            self.base = base

        def __call__(self, payload):
            if "stream" in payload:
                return ({"i": i} for i in range(payload["stream"]))
            return {"sum": self.base + payload["x"]}

        def fail(self, msg):
            raise ValueError(f"bad input: {msg}")

    @serve.deployment(num_replicas=1, max_concurrent_queries=1,
                      max_queued_requests=0, name="Busy")
    class Busy:
        def __call__(self, payload=None):
            time.sleep(1.0)
            return "done"

    @serve.deployment(num_replicas=1, name="Late")
    class Late:
        def __call__(self, payload=None):
            time.sleep(0.8)
            return "late"

    h = serve.run(Calc.bind(100))
    serve.run(Busy.bind())
    serve.run(Late.bind())
    out["handle"] = [h.remote({"x": i}).result(timeout=60) for i in range(4)]
    out["stream"] = [rt.get(r, timeout=60) for r in
                     h.options(stream=True).remote({"stream": 3})]
    try:
        h.method("fail").remote("x=-1").result(timeout=60)
        out["error"] = None
    except Exception as e:  # noqa: BLE001 — compared across packages
        # the remote traceback's last line names the user's exception
        out["error"] = (type(e).__name__, e.function_name,
                        e.traceback_str.strip().splitlines()[-1])
    with pytest.raises(Exception) as ei:
        h.options(timeout_s=1e-9).remote({"x": 0})
    out["expired_before_send"] = type(ei.value).__name__
    status = serve.status()
    out["status"] = {n: status[n]["running"] for n in sorted(status)}

    base = serve.start(http_port=0)
    deadline = time.time() + 30
    while True:
        try:
            r = httpx.post(f"{base}/Calc", json={"x": 5}, timeout=30)
            break
        except httpx.TransportError:
            assert time.time() < deadline, "the proxy never answered"
            time.sleep(0.3)
    out["http"] = (r.status_code, r.json())
    r = httpx.post(f"{base}/Nope", json={}, timeout=30)
    out["http_404"] = r.status_code
    out["routes"] = sorted(httpx.get(f"{base}/-/routes", timeout=30).json())
    r = httpx.post(f"{base}/Calc", json={"y": 1}, timeout=30)
    out["http_user_error"] = (r.status_code, r.json().get("type"))

    # a shed: the one slot taken by a slow call, no queue
    long = {}
    t = threading.Thread(target=lambda: long.setdefault(
        "r", httpx.post(f"{base}/Busy", json=1, timeout=30)))
    t.start()
    time.sleep(0.3)
    r = httpx.post(f"{base}/Busy", json=2, timeout=30)
    t.join(timeout=60)
    out["http_503"] = (r.status_code, r.headers.get("Retry-After"),
                       r.json()["type"])
    out["http_long"] = (long["r"].status_code, long["r"].json())
    # a deadline spent while the callable runs
    r = httpx.post(f"{base}/Late", json=3, timeout=30,
                   headers={"X-Serve-Timeout-S": "0.2"})
    out["http_504"] = (r.status_code, r.json()["type"])
    hz = httpx.get(f"{base}/-/healthz", timeout=10).json()
    out["healthz"] = (hz["shed"] >= 1, hz["deadline_exceeded"] >= 1)
    return out


def _run(rt) -> dict:
    serve = importlib.import_module(f"{rt.__name__}.serve")
    rt.init(num_cpus=6)
    try:
        return _program(rt, serve)
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            # the program leaves ObjectRefs in cyclic garbage. The JAX
            # package's finaliser takes its reference counter's lock, so a
            # later cluster's GC run inside that lock (in whatever test
            # this worker runs next) deadlocks on them (ROADMAP Queue 3).
            # With no cluster up the finaliser does nothing: collect now.
            gc.collect()


@pytest.fixture(scope="module")
def results():
    return {"jax": _run(ray_tpu), "port": _run(ray_tpu_torch)}


@pytest.mark.parametrize("key", [
    "handle", "stream", "error", "expired_before_send", "status", "http",
    "http_404", "routes", "http_user_error", "http_503", "http_long",
    "http_504", "healthz"])
def test_serve_program_matches_jax(results, key):
    assert results["port"][key] == results["jax"][key]
    assert results["jax"][key] is not None


def test_serve_program_results_are_the_expected_ones(results):
    """Both packages agree, and on the right answers."""
    got = results["port"]
    assert got["handle"] == [{"sum": 100 + i} for i in range(4)]
    assert got["stream"] == [{"i": i} for i in range(3)]
    assert got["error"][0] == "TaskError"
    assert got["error"][2] == "ValueError: bad input: x=-1"
    assert got["expired_before_send"] == "DeadlineExceededError"
    assert got["status"] == {"Busy": 1, "Calc": 2, "Late": 1}
    assert got["http"] == (200, {"result": {"sum": 105}})
    assert got["http_404"] == 404
    assert got["routes"] == ["Busy", "Calc", "Late"]
    assert got["http_503"][0] == 503 and got["http_503"][1]
    assert got["http_503"][2] == "backpressure"
    assert got["http_long"] == (200, {"result": "done"})
    assert got["http_504"] == (504, "deadline_exceeded")
    assert got["healthz"] == (True, True)
