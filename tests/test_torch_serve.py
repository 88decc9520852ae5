"""The port's serve library (``ray_tpu_torch.serve``) on the port's own
cluster, against the cases of ``test_serve.py`` (deployments, routing,
autoscaling, HTTP and gRPC ingress, batching, multiplexing, config files,
local testing mode) and ``test_serve_proxy_fleet.py`` (a proxy on every
node).

The controller, the proxies, the replicas of these deployments and the
handles import no torch, so these tests run in the pytest worker. Every
ingress binds port 0 and reports the port it got: files that run at once
under xdist never race for a fixed port.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.metrics import reset_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The conftest fixture resets the JAX package's registries; this one
    resets the port's."""
    yield
    GLOBAL_CONFIG.reset()
    chaos.reset()
    reset_registry()


def _post_until_up(url, payload, timeout=30.0):
    """POST once the proxy answers (it binds lazily, on its first ready)."""
    import httpx

    deadline = time.time() + timeout
    while True:
        try:
            return httpx.post(url, json=payload, timeout=30)
        except httpx.TransportError:
            if time.time() > deadline:
                raise
            time.sleep(0.3)


# -- the proxy fleet (test_serve_proxy_fleet.py): a cluster of two nodes, ---
# -- ended before the single-node cluster below starts ----------------------


class TestProxyFleet:
    @pytest.fixture(scope="class")
    def fleet(self):
        c = Cluster(initialize_head=True, head_resources={"CPU": 4})
        c.add_node(resources={"CPU": 4})
        rt.init(address=c.address)
        yield c
        serve.shutdown()
        rt.shutdown()
        c.shutdown()

    def test_fleet_spans_nodes_and_serves(self, fleet):
        import httpx

        @serve.deployment(num_replicas=2)
        def hello(x):
            return f"hi:{x}"

        serve.run(hello.bind())
        serve.start(http_port=0, proxy_location="every_node")
        urls = serve.proxy_urls()
        assert len(urls) == 2, urls  # one proxy per daemon
        assert len(set(urls.values())) == 2
        # requests enter through ANY node's proxy
        for url in urls.values():
            r = _post_until_up(f"{url}/hello", "x")
            assert r.status_code == 200, (url, r.text)
            assert r.json()["result"] == "hi:x"
            h = httpx.get(f"{url}/-/healthz", timeout=30)
            assert h.status_code == 200

    def test_fleet_heals_onto_new_nodes(self, fleet):
        before = serve.proxy_urls()
        fleet.add_node(resources={"CPU": 2})
        deadline = time.time() + 60
        while time.time() < deadline:
            urls = serve.proxy_urls()
            if len(urls) == 3:
                break
            time.sleep(0.5)
        else:
            pytest.fail(f"fleet never grew: {serve.proxy_urls()}")
        new_nodes = set(urls) - set(before)
        assert len(new_nodes) == 1
        r = _post_until_up(f"{urls[new_nodes.pop()]}/hello", "y")
        assert r.status_code == 200 and r.json()["result"] == "hi:y"

    def test_shutdown_reaps_fleet(self, fleet):
        urls = serve.proxy_urls()
        assert urls
        serve.shutdown()
        # controller gone; a fresh one reports no fleet
        assert serve.proxy_urls() == {}


# -- test_serve.py -----------------------------------------------------------


@pytest.fixture(scope="module")
def ray_init():
    info = rt.init(num_cpus=8)
    yield info
    try:
        serve.shutdown()
    except Exception:
        pass
    rt.shutdown()


@pytest.fixture
def _cleanup_deployments(ray_init):
    yield
    for name in list(serve.status()):
        serve.delete(name)


def _echo_class():
    @serve.deployment(num_replicas=2)
    class Echo:
        def __init__(self, prefix="echo"):
            self.prefix = prefix

        def __call__(self, x):
            return f"{self.prefix}:{x}"

    return Echo.bind(prefix="hi"), "Echo", 2, lambda x: f"hi:{x}"


def _echo_function():
    @serve.deployment
    def double(x):
        return x * 2

    return double.bind(), "double", 1, lambda x: x * 2


@pytest.mark.parametrize("make", [_echo_class, _echo_function],
                         ids=["class", "function"])
def test_deploy_and_call(ray_init, _cleanup_deployments, make):
    """A class deployment with bound constructor arguments over 2
    replicas, and a function deployment (test_serve.py's
    test_deploy_and_call and test_function_deployment)."""
    app, name, replicas, want = make()
    handle = serve.run(app)
    assert handle.remote(21).result(timeout=60) == want(21)
    results = [handle.remote(i).result(timeout=60) for i in range(10)]
    assert results == [want(i) for i in range(10)]
    assert serve.status()[name]["running"] == replicas


def test_method_call_and_redeploy(ray_init, _cleanup_deployments):
    @serve.deployment(num_replicas=1)
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def __call__(self, _x=None):
            return "root"

        def incr(self):
            self.n += 1
            return self.n

    handle = serve.run(Counter.bind())
    assert handle.method("incr").remote().result(timeout=60) == 1
    assert handle.method("incr").remote().result(timeout=60) == 2
    # identical config redeploys are IN-PLACE: state survives
    handle = serve.run(Counter.bind())
    assert handle.method("incr").remote().result(timeout=60) == 3
    # a CONFIG CHANGE rolls the replicas: state resets
    handle = serve.run(Counter.bind(start=10))
    time.sleep(0.5)
    assert handle.method("incr").remote().result(timeout=60) == 11


def test_routing_spreads_load(ray_init, _cleanup_deployments):
    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __call__(self, _x=None):
            import os

            return os.getpid()

    handle = serve.run(WhoAmI.bind())
    pids = {handle.remote().result(timeout=60) for _ in range(30)}
    assert len(pids) >= 2  # power-of-two-choices touches multiple replicas


def test_autoscaling_up_under_load(ray_init, _cleanup_deployments):
    @serve.deployment(
        autoscaling_config={
            "min_replicas": 1, "max_replicas": 3,
            "target_ongoing_requests": 1,
        },
    )
    class Slow:
        def __call__(self, _x=None):
            import time as t

            t.sleep(1.2)
            return "done"

    handle = serve.run(Slow.bind())
    assert serve.status()["Slow"]["running"] == 1
    # flood: 9 concurrent slow requests push ongoing >> target
    refs = [handle.remote(i) for i in range(9)]
    deadline = time.time() + 30
    scaled = 0
    while time.time() < deadline:
        scaled = serve.status()["Slow"]["running"]
        if scaled >= 2:
            break
        time.sleep(0.5)
    assert scaled >= 2, "autoscaler never scaled up under load"
    for r in refs:
        assert r.result(timeout=120) == "done"


def test_http_ingress_roundtrip(ray_init, _cleanup_deployments):
    import httpx

    @serve.deployment(num_replicas=2)
    class Adder:
        def __call__(self, payload):
            return {"sum": payload["a"] + payload["b"]}

    serve.run(Adder.bind())
    base = serve.start(http_port=0)
    assert not base.endswith(":0"), base  # the port it bound
    r = _post_until_up(f"{base}/Adder", {"a": 2, "b": 3})
    assert r.status_code == 200
    assert r.json()["result"]["sum"] == 5
    # unknown deployment -> 404
    r2 = httpx.post(f"{base}/Nope", json={}, timeout=30)
    assert r2.status_code == 404
    # routes listing
    r3 = httpx.get(f"{base}/-/routes", timeout=30)
    assert "Adder" in r3.json()


def test_shutdown_then_redeploy(ray_init, _cleanup_deployments):
    """serve.shutdown must reap every detached replica before returning —
    a fresh controller then reuses replica names without collisions."""

    @serve.deployment(num_replicas=2)
    def ping(_x=None):
        return "pong"

    handle = serve.run(ping.bind())
    assert handle.remote().result(timeout=60) == "pong"
    serve.shutdown()
    handle = serve.run(ping.bind())
    assert handle.remote().result(timeout=60) == "pong"


def test_handle_as_task_arg(ray_init, _cleanup_deployments):
    """A DeploymentHandle survives pickling into a remote task and routes
    from there."""

    @serve.deployment(num_replicas=1)
    def triple(x):
        return x * 3

    handle = serve.run(triple.bind())

    @rt.remote
    def call_through(h, v):
        return h.remote(v).result(timeout=60)

    assert rt.get(call_through.remote(handle, 4), timeout=60) == 12


def test_tracked_ref_works_with_get(ray_init, _cleanup_deployments):
    """rt.get() accepts the handle's tracked ref wrapper."""

    @serve.deployment(num_replicas=1)
    def identity(x):
        return x

    handle = serve.run(identity.bind())
    ref = handle.remote("v")
    assert rt.get(ref, timeout=60) == "v"
    assert rt.get([handle.remote(1), handle.remote(2)], timeout=60) == [1, 2]


def test_replica_failure_recovery(ray_init, _cleanup_deployments):
    @serve.deployment(num_replicas=2)
    class Fragile:
        def __call__(self, x=None):
            return "ok"

        def die(self):
            import os

            os._exit(1)

    handle = serve.run(Fragile.bind())
    assert handle.remote().result(timeout=60) == "ok"
    try:
        handle.method("die").remote().result(timeout=30)
    except Exception:
        pass
    # die() is a poison pill each budget-approved failover re-sends, so
    # the first requests after it may fail; recovery means requests
    # succeed repeatedly once the reconcile loop has replaced the corpses
    deadline = time.time() + 45
    streak = 0
    while time.time() < deadline and streak < 3:
        try:
            assert handle.remote().result(timeout=60) == "ok"
            streak += 1
        except (rt.ActorUnavailableError, rt.ActorDiedError):
            streak = 0
            time.sleep(0.5)
    assert streak == 3, "service never converged after replica kills"
    deadline = time.time() + 30
    while time.time() < deadline:
        if serve.status()["Fragile"]["running"] == 2:
            break
        time.sleep(0.5)
    assert serve.status()["Fragile"]["running"] == 2


def test_serve_batch(ray_init, _cleanup_deployments):
    """@serve.batch coalesces single calls into one batched invocation."""

    @serve.deployment
    class Batcher:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def __call__(self, items):
            self.batch_sizes.append(len(items))
            return [x * 10 for x in items]

        async def sizes(self):
            return list(self.batch_sizes)

    handle = serve.run(Batcher.bind())
    refs = [handle.remote(i) for i in range(8)]
    out = sorted(r.result(timeout=60) for r in refs)
    assert out == [i * 10 for i in range(8)]
    sizes = handle.method("sizes").remote().result(timeout=30)
    assert sum(sizes) == 8
    assert max(sizes) > 1, f"no batching happened: {sizes}"


def test_serve_multiplex(ray_init, _cleanup_deployments):
    """@serve.multiplexed LRU model loading + sticky model routing."""

    @serve.deployment(num_replicas=2)
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"model": model_id}

        async def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            model = await self.get_model(mid)
            return f"{model['model']}:{x}"

        async def load_log(self):
            return list(self.loads)

    handle = serve.run(MultiModel.bind())
    outs = [
        handle.options(multiplexed_model_id="m1").remote(i).result(timeout=60)
        for i in range(4)
    ]
    assert outs == [f"m1:{i}" for i in range(4)]
    out2 = handle.options(multiplexed_model_id="m2").remote(9).result(
        timeout=60)
    assert out2 == "m2:9"
    # sticky routing: m1 was loaded exactly once across the replica pool
    logs = [
        handle._replicas[i].call_method.remote("load_log")
        for i in range(len(handle._replicas))
    ]
    all_loads = sum(rt.get(logs, timeout=30), [])
    assert all_loads.count("m1") == 1, all_loads


def test_cross_handle_load_signal(ray_init, _cleanup_deployments):
    """Two handles converge on replica load via the probed queue-len cache:
    a fresh handle skews away from the replica another handle saturated."""

    class Slow:
        def __call__(self, delay):
            time.sleep(delay)
            import os

            return os.getpid()

    handle1 = serve.run(serve.Deployment(
        Slow, "crosshandle", num_replicas=2))
    warm = {rt.get(handle1.remote(0.0), timeout=60) for _ in range(16)}
    assert len(warm) == 2
    # saturate ONE replica via sticky multiplexed routing through handle1
    sticky = handle1.options(multiplexed_model_id="pin")
    busy_pid = rt.get(sticky.remote(0.0), timeout=60)
    held = [sticky.remote(2.5) for _ in range(8)]
    time.sleep(1.2)  # > probe TTL: probes observe the true queue lengths
    handle2 = serve.get_deployment_handle("crosshandle")
    quick_pids = [rt.get(handle2.remote(0.0), timeout=60) for _ in range(12)]
    rt.get(held, timeout=120)
    on_busy = sum(1 for p in quick_pids if p == busy_pid)
    assert on_busy <= 4, (
        f"fresh handle sent {on_busy}/12 requests to the saturated replica "
        f"(busy={busy_pid}, picks={quick_pids})")


def test_handle_streaming(ray_init, _cleanup_deployments):
    """handle.options(stream=True): items arrive as the generator makes
    them."""

    @serve.deployment(num_replicas=1)
    class Streamer:
        def __call__(self, n):
            for i in range(int(n)):
                yield {"i": i}

    handle = serve.run(Streamer.bind())
    stream = handle.options(stream=True).remote(4)
    items = [rt.get(ref, timeout=60) for ref in stream]
    assert items == [{"i": i} for i in range(4)]
    stream2 = handle.options(stream=True).remote(0)
    assert [rt.get(r, timeout=60) for r in stream2] == []


def test_http_sse_streaming_incremental(ray_init, _cleanup_deployments):
    """N SSE events arrive BEFORE the generation completes."""
    import httpx

    @serve.deployment(num_replicas=1)
    class SlowGen:
        def __call__(self, payload):
            for i in range(5):
                time.sleep(0.25)
                yield {"tok": i}

    serve.run(SlowGen.bind())
    base = serve.start(http_port=0)
    arrival_times = []
    events = []
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            with httpx.stream(
                    "POST", f"{base}/SlowGen?stream=1", json={"x": 1},
                    timeout=60) as r:
                assert r.headers["content-type"].startswith(
                    "text/event-stream")
                for line in r.iter_lines():
                    if line.startswith("data: "):
                        arrival_times.append(time.monotonic())
                        events.append(line[len("data: "):])
            break
        except httpx.TransportError:
            time.sleep(0.5)
    assert events[-1] == "[DONE]"
    payloads = events[:-1]
    assert [json.loads(p)["tok"] for p in payloads] == list(range(5))
    # incremental: a buffered response would collapse all arrivals
    assert arrival_times[-1] - arrival_times[0] > 0.4, (
        "all SSE events arrived at once — response was buffered")


def test_http_proxy_draining(ray_init, _cleanup_deployments):
    import httpx

    @serve.deployment(num_replicas=1)
    class Ok:
        def __call__(self, x):
            return x

    serve.run(Ok.bind())
    base = serve.start(http_port=0)
    assert _post_until_up(f"{base}/Ok", 1).status_code == 200
    proxy = rt.get_actor("serve-http-proxy", namespace="_serve")
    assert rt.get(proxy.drain.remote(), timeout=30) is True
    r = httpx.post(f"{base}/Ok", json=1, timeout=30)
    assert r.status_code == 503
    hz = httpx.get(f"{base}/-/healthz", timeout=30)
    assert hz.status_code == 503
    # a drained proxy stays drained until serve shuts down
    serve.shutdown()


def test_config_file_deploy_and_cli_schema(ray_init, _cleanup_deployments,
                                           tmp_path):
    """Config-file deploy: applications resolve from import_path with
    overrides applied."""
    (tmp_path / "my_app_torch.py").write_text(
        "from ray_tpu_torch import serve\n"
        "\n"
        "@serve.deployment(num_replicas=1)\n"
        "class Adder:\n"
        "    def __init__(self, inc=1):\n"
        "        self.inc = inc\n"
        "    def __call__(self, x):\n"
        "        return x + self.inc\n"
        "\n"
        "adder_app = Adder.bind(inc=5)\n"
        "\n"
        "def builder():\n"
        "    return Adder.options(name='Built').bind(inc=7)\n")
    sys.path.insert(0, str(tmp_path))
    try:
        cfg = {
            "applications": [
                {"import_path": "my_app_torch:adder_app", "num_replicas": 2},
                {"import_path": "my_app_torch:builder"},
            ],
        }
        import yaml

        path = tmp_path / "serve.yaml"
        path.write_text(yaml.safe_dump(cfg))
        handles = serve.deploy_config(str(path), start_http=False)
        assert set(handles) == {"Adder", "Built"}
        assert handles["Adder"].remote(1).result(timeout=60) == 6
        assert handles["Built"].remote(1).result(timeout=60) == 8
        assert serve.status()["Adder"]["running"] == 2
        from ray_tpu_torch.serve import build_config

        built = build_config(
            serve.Deployment(lambda x: x, "X", num_replicas=3))
        assert built["applications"][0]["num_replicas"] == 3
    finally:
        sys.path.remove(str(tmp_path))


def test_config_push_invalidates_handles_without_ttl(
        ray_init, _cleanup_deployments, monkeypatch):
    """Replica-set changes PUSH to handles: with the TTL disabled, a
    scaled deployment is still visible to an existing handle promptly."""
    from ray_tpu_torch.serve import _handle as handle_mod

    monkeypatch.setattr(handle_mod, "_REFRESH_S", 1e9)

    @serve.deployment(num_replicas=1)
    class Pushed:
        def __call__(self, x):
            return x

    handle = serve.run(Pushed.bind())
    assert handle.remote(1).result(timeout=60) == 1
    assert len(handle._replicas) == 1
    serve.run(Pushed.options(num_replicas=2).bind())
    deadline = time.time() + 60
    while time.time() < deadline and len(handle._replicas) != 2:
        handle._refresh()  # no-op unless the push marked the handle stale
        time.sleep(0.2)
    assert len(handle._replicas) == 2, "push never refreshed the handle"
    assert handle.remote(2).result(timeout=60) == 2


def test_grpc_ingress_unary_and_streaming(ray_init, _cleanup_deployments):
    """gRPC ingress: unary calls and server-streaming generator
    deployments over a generic bytes service, on a port it picked."""
    import grpc

    @serve.deployment(num_replicas=1)
    class Echoer:
        def __call__(self, payload):
            if isinstance(payload, dict) and payload.get("stream"):
                def gen():
                    for i in range(int(payload["n"])):
                        yield {"i": i}
                return gen()
            return {"echo": payload}

    serve.run(Echoer.bind())
    addr = serve.start_grpc(grpc_port=0)
    assert not addr.endswith(":0"), addr

    channel = grpc.insecure_channel(addr)
    unary = channel.unary_unary(
        "/ray_tpu_torch.serve.Serve/Call",
        request_serializer=bytes, response_deserializer=bytes)
    md = (("rt-serve-deployment", "Echoer"),)
    reply = json.loads(unary(json.dumps({"x": 7}).encode(),
                             metadata=md, timeout=60))
    assert reply["result"]["echo"] == {"x": 7}

    stream = channel.unary_stream(
        "/ray_tpu_torch.serve.Serve/CallStream",
        request_serializer=bytes, response_deserializer=bytes)
    items = [json.loads(m) for m in stream(
        json.dumps({"stream": True, "n": 3}).encode(),
        metadata=md, timeout=60)]
    assert items == [{"i": 0}, {"i": 1}, {"i": 2}]

    # unknown deployment -> NOT_FOUND; missing metadata -> INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as e:
        unary(b"{}", metadata=(("rt-serve-deployment", "Nope"),), timeout=30)
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    with pytest.raises(grpc.RpcError) as e:
        unary(b"{}", timeout=30)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    channel.close()


def test_version_pinned_redeploy_rescales_in_place(ray_init,
                                                   _cleanup_deployments):
    """A pinned `version` is the deployment's code identity: redeploys
    with the same version do not roll even when the pickled callable
    differs; a version bump rolls."""

    def make(tag):
        @serve.deployment(num_replicas=1, name="Versioned", version="v1")
        class Versioned:
            def __init__(self):
                self.n = 0

            def __call__(self, _x=None):
                return tag

            def incr(self):
                self.n += 1
                return self.n

        return Versioned

    handle = serve.run(make("first").bind())
    assert handle.remote().result(timeout=60) == "first"
    assert handle.method("incr").remote().result(timeout=60) == 1
    handle = serve.run(make("second").bind())
    assert handle.method("incr").remote().result(timeout=60) == 2
    assert handle.remote().result(timeout=60) == "first"
    handle = serve.run(make("third").options(version="v2").bind())
    time.sleep(0.5)
    assert handle.remote().result(timeout=60) == "third"
    assert handle.method("incr").remote().result(timeout=60) == 1


REAP_TICK_S = 0.1  # node_daemon.py::_reap_loop's period


def _running(pid):
    """Whether ``pid`` is a live process (a zombie is not)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return bool(f.read())
    except OSError:
        return False


def test_delete_leaves_the_actors_a_replica_made(ray_init,
                                                 _cleanup_deployments):
    """As in the JAX package: deleting a deployment ends its replica, and
    the actors the replica made (an LLM ingress's engines) live on until
    they are killed; a detached one as well."""
    from ray_tpu_torch.util.state import list_actors

    def make():
        @rt.remote
        class Child:
            def ping(self):
                return "child"

        @serve.deployment(num_replicas=1, name="Parent")
        class Parent:
            def __init__(self):
                self.child = Child.remote()
                self.kept = Child.options(
                    name="kept-child", lifetime="detached").remote()

            def __call__(self, _x=None):
                return rt.get([self.child.ping.remote(),
                               self.kept.ping.remote()], timeout=30)

        return Parent

    serve.status()  # the controller, made now if it is not yet
    before = {a["actor_id"] for a in list_actors()}
    handle = serve.run(make().bind())
    assert handle.remote().result(timeout=60) == ["child", "child"]
    serve.delete("Parent")

    def states():
        return {a["name"]: a["state"] for a in list_actors()
                if a["actor_id"] not in before}

    deadline = time.time() + 30
    while time.time() < deadline and \
            states().get("serve:Parent:0") == "ALIVE":
        time.sleep(0.2)
    time.sleep(1.0)  # the replica's death is recorded: its child stays
    got = states()
    assert got == {"": "ALIVE", "serve:Parent:0": "DEAD",
                   "kept-child": "ALIVE"}, got
    cw = rt.get_core_worker()  # no handle here reaches them: kill by id
    for a in list_actors():
        if a["actor_id"] not in before and a["state"] == "ALIVE":
            cw.run_sync(cw.kill_actor(bytes.fromhex(a["actor_id"]), True), 30)
    deadline = time.time() + 30
    while time.time() < deadline and "ALIVE" in states().values():
        time.sleep(0.2)
    assert set(states().values()) == {"DEAD"}, states()


def test_actor_made_in_a_task_outlives_its_reaped_worker(ray_init):
    """A named actor that a task made lives on when the worker pool reaps
    that task's idle worker, as in the JAX package. The creating task and
    ``worker_pool_max_idle + 2`` holding tasks meet at a barrier, so each
    runs on a worker of its own while the others run (a finished task's
    worker cannot take a later one, and none takes the creator's). The
    creator returns at the barrier and the holders a while later, so its
    worker is the oldest of more than ``worker_pool_max_idle`` idle ones,
    the one the pool reaps."""
    n = GLOBAL_CONFIG.get("worker_pool_max_idle") + 2
    # a worker goes idle when its lease has been unused this long, and the
    # daemon's reap loop looks at the idle pool every REAP_TICK_S
    reap_s = GLOBAL_CONFIG.get("worker_lease_idle_s") + REAP_TICK_S

    @rt.remote
    class Barrier:
        def __init__(self):
            self.arrived = 0

        def arrive(self):
            self.arrived += 1

        def count(self):
            return self.arrived

    def meet(barrier, parties):
        rt.get(barrier.arrive.remote(), timeout=30)
        deadline = time.time() + 60
        while rt.get(barrier.count.remote(), timeout=30) < parties:
            if time.time() > deadline:
                raise TimeoutError("the tasks did not all start")
            time.sleep(0.05)

    @rt.remote
    class Kept:
        def ping(self):
            return "kept"

    @rt.remote
    def make(name, barrier, parties):
        h = Kept.options(name=name).remote()
        rt.get(h.ping.remote(), timeout=30)
        meet(barrier, parties)
        return os.getpid()

    @rt.remote
    def hold(barrier, parties, after_s):
        meet(barrier, parties)
        time.sleep(after_s)
        return os.getpid()

    barrier = Barrier.remote()
    made = make.remote("made-in-task", barrier, n + 1)
    # each holder a resource shape of its own: a lease each, so no worker
    # is handed a second holder behind the first
    held = [hold.options(num_cpus=0.01 * (i + 1)).remote(
        barrier, n + 1, 4 * reap_s) for i in range(n)]
    creator = rt.get(made, timeout=120)
    pids = rt.get(held, timeout=120)
    assert creator not in pids and len(set(pids)) == n, (creator, pids)
    deadline = time.time() + 60 * reap_s
    while _running(creator) and time.time() < deadline:
        time.sleep(0.2)
    assert not _running(creator), "the creator's idle worker was not reaped"
    kept = rt.get_actor("made-in-task")
    assert rt.get(kept.ping.remote(), timeout=30) == "kept"
    rt.kill(kept)
    rt.kill(barrier)


def test_local_testing_mode_no_cluster():
    """Deployment logic runs in-process with the DeploymentHandle surface:
    no controller, replicas or cluster. It uses no cluster fixture."""

    @serve.deployment
    class Calc:
        def __init__(self, base=10):
            self.base = base

        def __call__(self, x):
            return self.base + x

        def double(self, x):
            return 2 * x

        def stream_to(self, n):
            for i in range(n):
                yield i

        def boom(self):
            raise ValueError("local boom")

    h = serve.run(Calc.bind(base=100), _local_testing_mode=True)
    assert h.remote(5).result() == 105
    assert h.method("double").remote(21).result() == 42
    items = [r.result() for r in
             h.method("stream_to").options(stream=True).remote(3)]
    assert items == [0, 1, 2]
    with pytest.raises(ValueError, match="local boom"):
        h.method("boom").remote().result()

    @serve.deployment
    def plain(x):
        return x * 3

    h2 = serve.run(plain.bind(), _local_testing_mode=True)
    assert h2.remote(7).result() == 21


# -- the package's surface ---------------------------------------------------


def test_public_names_match_the_jax_package():
    import ray_tpu.serve as jserve
    import ray_tpu.util.state as jstate
    import ray_tpu_torch.util.state as state

    assert serve.__all__ == jserve.__all__
    assert [n for n in dir(state) if not n.startswith("_")] == [
        n for n in dir(jstate) if not n.startswith("_")]


def test_serve_imports_no_torch_in_a_fresh_interpreter():
    """``from ray_tpu_torch import serve`` and every serve module the
    controller, proxies and handles run load neither torch nor JAX."""
    code = (
        "import sys\n"
        "from ray_tpu_torch import serve\n"
        "import ray_tpu_torch.serve._http, ray_tpu_torch.serve._grpc\n"
        "import ray_tpu_torch.serve._controller, ray_tpu_torch.serve._local\n"
        "import ray_tpu_torch.util.state, ray_tpu_torch.util.tracing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'ray_tpu')]\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
