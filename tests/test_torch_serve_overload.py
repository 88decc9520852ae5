"""The port's serve overload plane (``ray_tpu_torch.serve``) on the port's
own cluster: the cases of ``test_serve_overload.py`` (end-to-end
deadlines, bounded queues and load shedding, retry budgets, outlier
ejection, serving through a controller outage, the HTTP codes) and the
tier-1 seed of ``test_serve_chaos.py`` (replica kills, stalls and wedges,
an overload burst and a controller kill under seeded event-loop delay).

Each group runs on a cluster of its own, started for its class: the
chaos cluster's controller takes its probe bounds from the config it was
started with. Nothing here imports torch, so the tests run in the pytest
worker; the HTTP ingress binds port 0.
"""

import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.serve import BackpressureError, DeadlineExceededError
from ray_tpu_torch.util.metrics import reset_registry


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The conftest fixture resets the JAX package's registries after each
    test; this one resets the port's."""
    yield
    GLOBAL_CONFIG.reset()
    chaos.reset()
    reset_registry()


def _no_retries():
    """Disable handle failover so admission errors surface raw."""
    GLOBAL_CONFIG.apply_system_config({
        "serve_retry_budget_min": 0,
        "serve_retry_budget_ratio": 0.0,
    })


def _stats(handle, i=0):
    return rt.get(handle._replicas[i].stats.remote(), timeout=30)


class TestOverload:
    """test_serve_overload.py's cases."""

    @pytest.fixture(scope="class")
    def ray_init(self):
        info = rt.init(num_cpus=8)
        yield info
        try:
            serve.shutdown()
        except Exception:
            pass
        rt.shutdown()

    @pytest.fixture(autouse=True)
    def _cleanup_deployments(self, request):
        yield
        if "ray_init" not in request.fixturenames:
            return
        try:
            for name in list(serve.status()):
                serve.delete(name)
        except Exception:
            pass

    def test_bounded_queue_sheds_with_typed_error(self, ray_init):
        """max_queued_requests bounds the replica queue; excess requests get
        a typed BackpressureError carrying retry_after_s, and the queue
        high-water provably never exceeds the bound."""
        _no_retries()

        @serve.deployment(num_replicas=1, max_concurrent_queries=1,
                          max_queued_requests=1)
        class Slow:
            def __call__(self, x=None):
                time.sleep(0.5)
                return "ok"

        handle = serve.run(Slow.bind())
        refs = [handle.remote(i) for i in range(6)]
        outcomes = []
        for r in refs:
            try:
                outcomes.append(r.result(timeout=30))
            except BackpressureError as e:
                assert e.retry_after_s > 0
                outcomes.append("shed")
        # 1 running + 1 queued admitted; the rest shed
        assert outcomes.count("ok") >= 2
        assert outcomes.count("shed") >= 3
        st = _stats(handle)
        assert st["shed"] >= 3
        assert st["max_queued"] == 1
        assert st["peak_queued"] <= 1, st
        # accepted + shed + deadline partitions admissions
        assert st["started"] == outcomes.count("ok")


    def test_ingress_shed_before_replica_rpc(self, ray_init):
        """Once the probed-load cache reads the replica at capacity, the
        handle sheds at ingress — no replica RPC, counted handle-side."""
        _no_retries()

        @serve.deployment(num_replicas=1, max_concurrent_queries=1,
                          max_queued_requests=0)
        class Busy:
            def __call__(self, x=None):
                time.sleep(0.8)
                return "ok"

        handle = serve.run(Busy.bind())
        first = handle.remote(0)  # occupies the only slot
        time.sleep(0.1)
        rejections = 0
        for i in range(4):
            try:
                handle.remote(i).result(timeout=10)
            except BackpressureError:
                rejections += 1
        assert rejections == 4
        # the FIRST rejection may be replica-side (cold cache: the queue-full
        # answer pins the load cache via _note_saturated) or already an
        # ingress shed (a background qlen probe read the busy replica first —
        # the usual case in a warm process) — but once pinned, every later
        # rejection must shed at ingress without spending a replica RPC
        assert handle.overload_stats["shed_ingress"] >= 3, handle.overload_stats
        assert first.result(timeout=30) == "ok"


    def test_deadline_never_reaches_callable(self, ray_init):
        """A request whose deadline is spent is failed by the replica's
        admission gate — the user callable provably never runs."""
        _no_retries()

        @serve.deployment(num_replicas=1)
        class Counting:
            def __init__(self):
                self.calls = 0

            def __call__(self, x=None):
                self.calls += 1
                return self.calls

            def count(self):
                return self.calls

        handle = serve.run(Counting.bind())
        # expired on ARRIVAL at the replica (bypasses the handle's local
        # fast-fail by stamping the wire kwarg directly)
        from ray_tpu_torch.serve._context import DEADLINE_KWARG
        from ray_tpu_torch._private.errors import TaskError

        ref = handle._replicas[0].handle_request.remote(
            "x", **{DEADLINE_KWARG: time.time() - 1.0})
        with pytest.raises(TaskError) as ei:
            rt.get(ref, timeout=30)
        assert isinstance(ei.value.__cause__, DeadlineExceededError)
        # expired BEFORE send: the handle fails it without any RPC (a tiny
        # positive budget is spent by the time routing checks it)
        with pytest.raises(DeadlineExceededError):
            handle.options(timeout_s=1e-9).remote("y")
        assert handle.overload_stats["expired_before_send"] >= 1
        st = _stats(handle)
        assert st["deadline_rejected"] >= 1
        assert rt.get(
            handle._replicas[0].call_method.remote("count"), timeout=30) == 0
        # the callable-started counter never moved for either request
        assert st["started"] == 0
        # explicit timeout_s=0 means NO deadline (matches the config flag's
        # "0 = no deadline" contract), not instant expiry
        assert handle.options(timeout_s=0).remote("z").result(timeout=30) == 1


    def test_deadline_expires_in_queue(self, ray_init):
        """A queued request whose deadline passes while waiting for a
        concurrency slot dies in the queue, not in user code."""
        _no_retries()

        @serve.deployment(num_replicas=1, max_concurrent_queries=1,
                          max_queued_requests=8)
        class Counting:
            def __init__(self):
                self.calls = 0

            def __call__(self, delay):
                self.calls += 1
                time.sleep(delay)
                return self.calls

        handle = serve.run(Counting.bind())
        long = handle.remote(0.8)
        time.sleep(0.1)
        with pytest.raises(DeadlineExceededError):
            handle.options(timeout_s=0.3).remote(0.0).result(timeout=30)
        assert long.result(timeout=30) == 1
        st = _stats(handle)
        assert st["deadline_rejected"] >= 1
        assert st["started"] == 1  # only the long request ran


    def test_deadline_visible_in_request_context(self, ray_init):
        """The deadline propagates handle -> replica request context:
        serve.get_request_deadline()/remaining_s() see it inside user code."""

        @serve.deployment(num_replicas=1)
        def probe(_x=None):
            from ray_tpu_torch import serve as s

            return {"deadline": s.get_request_deadline(),
                    "remaining": s.remaining_s()}

        handle = serve.run(probe.bind())
        t0 = time.time()
        out = handle.options(timeout_s=5.0).remote().result(timeout=30)
        assert abs(out["deadline"] - (t0 + 5.0)) < 1.0
        assert 0 < out["remaining"] <= 5.0
        # no deadline -> context reads empty
        out2 = handle.remote().result(timeout=30)
        assert out2 == {"deadline": 0.0, "remaining": None}


    def test_deadline_mid_stream(self, ray_init):
        """A stream whose consumer budget runs out stops mid-generation with
        a typed error — the replica checks between chunks."""
        _no_retries()

        @serve.deployment(num_replicas=1)
        class Gen:
            def __call__(self, _payload=None):
                for i in range(10):
                    time.sleep(0.25)
                    yield {"i": i}

        handle = serve.run(Gen.bind())
        stream = handle.options(stream=True, timeout_s=0.6).remote()
        got = []
        from ray_tpu_torch._private.errors import TaskError

        try:
            for ref in stream:
                got.append(rt.get(ref, timeout=10))
            raise AssertionError("stream ran past its deadline")
        except DeadlineExceededError:
            pass
        except TaskError as e:
            # the replica's mid-stream error can surface on an item ref
            assert isinstance(e.__cause__, DeadlineExceededError), e
        assert 1 <= len(got) < 10
        st = _stats(handle)
        assert st["deadline_mid_stream"] >= 1 or st["deadline_rejected"] >= 1


    def test_retry_budget_retries_queue_rejections_then_exhausts(self, ray_init):
        """Queue rejections fail over under the token-bucket budget; once the
        budget is spent the BackpressureError surfaces un-retried."""
        GLOBAL_CONFIG.apply_system_config({
            "serve_retry_budget_min": 2,
            "serve_retry_budget_ratio": 0.0,  # no deposits: only the floor
            "serve_shed_at_ingress": False,   # force replica-side rejections
        })

        @serve.deployment(num_replicas=1, max_concurrent_queries=1,
                          max_queued_requests=0)
        class Slow:
            def __call__(self, x=None):
                time.sleep(0.6)
                return "ok"

        handle = serve.run(Slow.bind())
        first = handle.remote(0)
        time.sleep(0.1)
        with pytest.raises(BackpressureError):
            handle.remote(1).result(timeout=30)
        stats = handle.overload_stats
        assert stats["retries"] >= 1, "budget floor must fund retries"
        assert stats["retries_denied"] >= 1, "exhausted budget must deny"
        assert first.result(timeout=30) == "ok"


    def test_outlier_ejection_and_probation(self, ray_init):
        """Consecutive failures eject a replica from routing; after the
        probation window it re-enters (first request = re-probe)."""
        GLOBAL_CONFIG.apply_system_config({
            "serve_outlier_consecutive_failures": 3,
            "serve_outlier_probation_s": 0.8,
        })

        @serve.deployment(num_replicas=2)
        class WhoAmI:
            def __call__(self, _x=None):
                import os

                return os.getpid()

        handle = serve.run(WhoAmI.bind())
        pids = {handle.remote().result(timeout=30) for _ in range(20)}
        assert len(pids) == 2
        bad_rid = handle._replicas[0]._actor_id.binary()
        bad_pid = rt.get(
            handle._replicas[0].call_method.remote("__call__"), timeout=30)
        for _ in range(3):
            handle._record_failure(bad_rid)
        assert handle.overload_stats["ejections"] == 1
        picks = [handle.remote().result(timeout=30) for _ in range(10)]
        assert bad_pid not in picks, "ejected replica still routed"
        # probation: after the window the replica serves again
        time.sleep(1.0)
        deadline = time.time() + 10
        seen = set()
        while time.time() < deadline and bad_pid not in seen:
            seen.add(handle.remote().result(timeout=30))
        assert bad_pid in seen, "probation re-probe never reached the replica"


    def test_degradation_serves_through_controller_outage(self, ray_init):
        """A controller kill (and the amnesiac auto-recreated controller that
        follows) must not wipe a handle's live routing table."""

        @serve.deployment(num_replicas=1)
        def steady(x=None):
            return "up"

        handle = serve.run(steady.bind())
        assert handle.remote().result(timeout=30) == "up"
        controller = rt.get_actor("serve-controller", namespace="_serve")
        rt.kill(controller)
        time.sleep(0.2)
        import math

        # dead-controller refresh: degrade, keep serving
        handle._last_refresh = -math.inf
        assert handle.remote().result(timeout=30) == "up"
        assert handle.overload_stats["stale_serves"] >= 1
        # amnesiac-controller refresh (fresh controller, no deployments):
        # known=False must NOT be treated as deletion
        handle._controller = None
        handle._last_refresh = -math.inf
        assert handle.remote().result(timeout=30) == "up"
        assert len(handle._replicas) == 1


    def test_batch_deadline_admission(self):
        """@serve.batch fails queued items whose deadline expired before the
        flush instead of spending batch slots on them (no cluster needed)."""
        import asyncio

        from ray_tpu_torch.serve import _context

        calls = []

        @serve.batch(max_batch_size=10, batch_wait_timeout_s=0.05)
        async def handler(items):
            calls.append(list(items))
            return [x * 2 for x in items]

        async def drive():
            tok = _context._set_deadline(time.time() - 1.0)  # already dead
            dead = asyncio.ensure_future(handler(1))
            _context._deadline_var.reset(tok)
            live = asyncio.ensure_future(handler(2))
            return await asyncio.gather(dead, live, return_exceptions=True)

        dead_res, live_res = asyncio.run(drive())
        assert isinstance(dead_res, DeadlineExceededError)
        assert live_res == 4
        assert calls == [[2]], "expired item must not ride into the batch"


    def test_http_maps_backpressure_and_deadline(self, ray_init):
        """HTTP ingress: shed -> 503 + Retry-After; spent deadline -> 504."""
        import httpx

        _no_retries()

        @serve.deployment(num_replicas=1, max_concurrent_queries=1,
                          max_queued_requests=0, name="OverHTTP")
        class Slow:
            def __call__(self, payload=None):
                time.sleep(0.8)
                return "done"

        serve.run(Slow.bind())
        base = serve.start(http_port=0)
        deadline = time.time() + 30
        while True:
            try:
                httpx.get(f"{base}/-/healthz", timeout=10)
                break
            except httpx.TransportError:
                if time.time() > deadline:
                    raise
                time.sleep(0.3)

        import threading

        codes = {}

        def long_call():
            codes["long"] = httpx.post(f"{base}/OverHTTP", json=1,
                                       timeout=30).status_code

        t = threading.Thread(target=long_call)
        t.start()
        time.sleep(0.25)
        r = httpx.post(f"{base}/OverHTTP", json=2, timeout=30)
        assert r.status_code == 503, r.text
        assert "Retry-After" in r.headers
        assert r.json()["type"] == "backpressure"
        t.join()
        assert codes["long"] == 200
        # deadline: X-Serve-Timeout-S expires while the callable runs -> 504.
        # A separate deployment so the 503 leg's pinned saturation reading
        # (fresh-at-capacity for ~2s) can't shed this request at ingress.
        @serve.deployment(num_replicas=1, name="OverHTTP2")
        class Slow2:
            def __call__(self, payload=None):
                time.sleep(0.8)
                return "done"

        serve.run(Slow2.bind())
        r2 = httpx.post(f"{base}/OverHTTP2", json=3, timeout=30,
                        headers={"X-Serve-Timeout-S": "0.2"})
        assert r2.status_code == 504, r2.text
        assert r2.json()["type"] == "deadline_exceeded"
        hz = httpx.get(f"{base}/-/healthz", timeout=10).json()
        assert hz["shed"] >= 1 and hz["deadline_exceeded"] >= 1


    def test_default_timeout_config_applies(self, ray_init):
        """serve_default_timeout_s supplies a deadline when the caller sets
        none — and an explicit timeout_s always wins."""
        GLOBAL_CONFIG.apply_system_config({"serve_default_timeout_s": 5.0})

        @serve.deployment(num_replicas=1, name="DefaultTimeout")
        def probe(_x=None):
            from ray_tpu_torch import serve as s

            return s.get_request_deadline()

        handle = serve.run(probe.bind())
        t0 = time.time()
        d = handle.remote().result(timeout=30)
        assert abs(d - (t0 + 5.0)) < 1.5
        d2 = handle.options(timeout_s=60.0).remote().result(timeout=30)
        assert d2 > time.time() + 30


    def test_sticky_multiplexed_requests_shed_at_ingress(self, ray_init):
        """Multiplexed (sticky-affinity) traffic rides the same ingress-shed
        machinery as pow-2 traffic: a saturated sticky replica sheds the
        request without a replica RPC instead of silently bypassing admission
        (sticky requests can only go to their replica, so its saturation
        alone justifies the shed)."""
        _no_retries()

        @serve.deployment(num_replicas=2, max_concurrent_queries=1,
                          max_queued_requests=0, name="StickyShed")
        class M:
            def __call__(self, x=None):
                return "ok"

        handle = serve.run(M.bind())
        sticky = handle.options(multiplexed_model_id="m1")
        assert sticky.remote(1).result(timeout=30) == "ok"
        rid = handle._model_affinity["m1"]
        # pin the sticky replica saturated on both ingress-shed signals
        with handle._lock:
            handle._inflight[rid] = handle._capacity
            handle._qlen_cache[rid] = (
                handle._capacity, handle._sent.get(rid, 0), time.monotonic())
        with pytest.raises(BackpressureError):
            sticky.remote(2)
        assert handle.overload_stats["shed_ingress"] >= 1
        # releasing the pin lets sticky traffic through again
        with handle._lock:
            handle._inflight[rid] = 0
        assert sticky.remote(3).result(timeout=30) == "ok"


# the tier-1 seed of test_serve_chaos.py (its other seeds are slow there)
CHAOS_SEED = 101

_CHAOS = {
    # control-plane handlers get 0.5-8ms of injected delay: enough to
    # shuffle orderings, small enough for tier-1 wall clock
    "testing_event_loop_delay_us": "*:500:8000",
    # controller-side probe bounds must be in the PRE-INIT config: the
    # controller actor's process inherits overrides at spawn, not from
    # later driver-side apply_system_config calls
    "serve_replica_init_timeout_s": 2.0,
    "serve_health_probe_timeout_s": 1.5,
}


def _delete_quiet(*names):
    for name in names:
        try:
            serve.delete(name)
        except Exception:  # noqa: BLE001
            pass


def _await_running(name, n, timeout=45):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if serve.status()[name]["running"] >= n:
                return True
        except Exception:  # noqa: BLE001 — controller mid-recreate
            pass
        time.sleep(0.25)
    return False


class TestChaos:
    """test_serve_chaos.py's four scenarios on its tier-1 seed; they share
    one cluster and each deletes its own deployments."""

    @pytest.fixture(scope="class")
    def chaos_init(self):
        cfg = dict(_CHAOS)
        cfg["testing_chaos_seed"] = CHAOS_SEED
        GLOBAL_CONFIG.apply_system_config(cfg)
        info = rt.init(num_cpus=8)
        yield info
        try:
            serve.shutdown()
        except Exception:  # noqa: BLE001
            pass
        rt.shutdown()
        GLOBAL_CONFIG.reset()

    def test_chaos_replica_kill_mid_request_and_mid_stream(self, chaos_init):
        @serve.deployment(num_replicas=2, name="Killable")
        class Killable:
            def __call__(self, payload=0.0):
                import os

                if isinstance(payload, dict) and payload.get("stream"):
                    def gen(n):
                        for i in range(int(n)):
                            time.sleep(0.15)
                            yield {"i": i, "pid": os.getpid()}

                    return gen(payload["n"])
                if payload:
                    time.sleep(payload)
                return os.getpid()

            def pid(self):
                import os

                return os.getpid()

            def die(self):
                import os

                os._exit(1)

        handle = serve.run(Killable.bind())
        pid_of = {
            r._actor_id.binary(): rt.get(
                r.call_method.remote("pid"), timeout=30)
            for r in handle._replicas
        }

        # -- mid-request: in-flight slow calls ride out a replica kill ------
        refs = [handle.remote(0.8) for _ in range(6)]
        time.sleep(0.2)
        victim = handle._replicas[0]
        victim_pid = pid_of[victim._actor_id.binary()]
        try:
            victim.call_method.remote("die")
        except Exception:  # noqa: BLE001
            pass
        results, failures = [], []
        for r in refs:
            try:
                results.append(r.result(timeout=60))
            except Exception as e:  # noqa: BLE001
                failures.append(e)
        # every request whose replica survived — or that failed over under
        # the retry budget — completed; nothing wedged
        assert len(results) >= 3, (results, failures)
        assert all(isinstance(p, int) for p in results)
        assert handle.overload_stats["retries"] >= 1 or not failures

        # the controller replaces the dead replica under traffic
        assert _await_running("Killable", 2), serve.status()

        # -- mid-stream: a kill surfaces a prompt error, no wedge -----------
        handle._refresh(force=True)
        stream = handle.options(stream=True).remote({"stream": True, "n": 20})
        first = rt.get(next(iter(stream)), timeout=30)
        streaming_pid = first["pid"]
        target = next(r for r in handle._replicas
                      if rt.get(r.call_method.remote("pid"), timeout=30)
                      == streaming_pid)
        try:
            target.call_method.remote("die")
        except Exception:  # noqa: BLE001
            pass
        t0 = time.monotonic()
        with pytest.raises(Exception):
            for ref in stream:
                rt.get(ref, timeout=30)
        assert time.monotonic() - t0 < 30, "mid-stream kill wedged the consumer"
        # and the deployment heals + serves again
        assert _await_running("Killable", 2)
        handle._refresh(force=True)
        assert isinstance(handle.remote(0.0).result(timeout=60), int)
        _delete_quiet("Killable")


    def test_chaos_stalled_replica_ejected_and_wedged_replica_replaced(self, chaos_init):
        # handle-side knobs: these are read in the driver, so a mid-test
        # apply works (the controller-side probe bounds ride the fixture cfg)
        GLOBAL_CONFIG.apply_system_config({
            "serve_outlier_consecutive_failures": 1,
            "serve_outlier_probation_s": 30.0,
        })

        # -- user-code stall: deadlines + ejection keep goodput -------------
        @serve.deployment(num_replicas=2, name="Stalls")
        class Stalls:
            def __init__(self):
                self.stall = False

            def __call__(self, _x=None):
                import os

                if self.stall:
                    time.sleep(60)
                return os.getpid()

            def make_slow(self):
                self.stall = True
                return True

        handle = serve.run(Stalls.bind())
        assert rt.get(
            handle._replicas[0].call_method.remote("make_slow"), timeout=30)
        ok, timed_out = 0, 0
        for i in range(12):
            try:
                p = handle.options(timeout_s=0.6).remote(i).result(timeout=30)
                assert isinstance(p, int)
                ok += 1
            except (DeadlineExceededError, rt.GetTimeoutError):
                timed_out += 1
        assert ok >= 8, f"goodput collapsed: ok={ok} timed_out={timed_out}"
        assert handle.overload_stats["ejections"] >= 1, (
            "stalled replica never ejected")
        # post-ejection, requests flow to the healthy replica only
        post = {handle.remote().result(timeout=30) for _ in range(5)}
        assert len(post) == 1

        # -- event-loop wedge: the bounded reconcile probe kills+replaces ---
        @serve.deployment(num_replicas=1, name="Wedged")
        class Wedged:
            def __init__(self):
                self.uptime_marker = time.time()

            def __call__(self, _x=None):
                return self.uptime_marker

            def wedge(self):
                self.block = True
                return True

            def check_health(self):
                # a blocking health check models a replica whose event loop
                # is wedged: EVERY actor method stalls behind it
                if getattr(self, "block", False):
                    time.sleep(3600)

        whandle = serve.run(Wedged.bind())
        marker0 = whandle.remote().result(timeout=60)
        rt.get(whandle._replicas[0].call_method.remote("wedge"), timeout=30)
        # the probe must time out, kill the wedged replica, and start a fresh
        # one — visible as a NEW uptime marker serving requests
        deadline = time.time() + 60
        marker1 = None
        while time.time() < deadline:
            try:
                whandle._refresh(force=True)
                marker1 = whandle.options(timeout_s=2.0).remote().result(
                    timeout=10)
                if marker1 != marker0:
                    break
            except Exception:  # noqa: BLE001 — mid-replacement
                time.sleep(0.5)
        assert marker1 is not None and marker1 != marker0, (
            "wedged replica never replaced — reconcile is frozen")

        # -- wedged __init__: bounded construction gate (2s via fixture cfg)
        @serve.deployment(num_replicas=1, name="InitWedge")
        class InitWedge:
            def __init__(self):
                time.sleep(3600)

            def __call__(self, _x=None):
                return "never"

        t0 = time.monotonic()
        with pytest.raises(Exception):
            serve.run(InitWedge.bind(), timeout=60)
        assert time.monotonic() - t0 < 45, "construction gate not bounded"
        # the controller survived and serves OTHER deployments (scale lock
        # was not wedged by the stuck constructor)
        assert isinstance(handle.remote().result(timeout=60), int)
        # InitWedge especially: leaving it deployed would have the reconcile
        # loop re-attempting (and gate-killing) the wedged constructor every
        # tick for the rest of the shared session
        _delete_quiet("Stalls", "Wedged", "InitWedge")


    def test_chaos_overload_burst_bounded_queues(self, chaos_init):
        GLOBAL_CONFIG.apply_system_config({
            "serve_retry_budget_min": 0,
            "serve_retry_budget_ratio": 0.0,
        })

        @serve.deployment(num_replicas=2, max_concurrent_queries=2,
                          max_queued_requests=2, name="Burst")
        class Burst:
            def __call__(self, _x=None):
                time.sleep(0.15)
                return "ok"

        handle = serve.run(Burst.bind())
        results = []
        lock = threading.Lock()

        def fire(i):
            try:
                out = handle.remote(i).result(timeout=60)
            except BackpressureError:
                out = "shed"
            except Exception as e:  # noqa: BLE001
                out = f"error:{e}"
            with lock:
                results.append(out)

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(40)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads), "burst wedged callers"
        assert len(results) == 40
        ok = results.count("ok")
        shed = results.count("shed")
        assert ok + shed == 40, f"unexpected outcomes: {results}"
        assert shed > 0, "a 5x-capacity burst must shed"
        assert ok >= 8, f"accepted goodput collapsed: {results}"
        # the queue bound provably held on every replica, and every admitted
        # request actually ran (total counts admissions; sheds never admit)
        for i in range(2):
            st = rt.get(handle._replicas[i].stats.remote(), timeout=30)
            assert st["peak_queued"] <= st["max_queued"], st
            assert st["started"] == st["total"], st
            assert st["shed"] > 0, st
        # the system drains: a fresh request succeeds promptly
        assert time.monotonic() - t0 < 60
        time.sleep(2.1)  # saturation cache ages out
        assert handle.remote().result(timeout=30) == "ok"
        _delete_quiet("Burst")


    def test_chaos_controller_kill_during_traffic(self, chaos_init):
        @serve.deployment(num_replicas=2, name="SurviveCtl")
        class Steady:
            def __call__(self, _x=None):
                return "up"

        handle = serve.run(Steady.bind())
        stop = threading.Event()
        outcomes = {"ok": 0, "fail": 0}

        def traffic():
            while not stop.is_set():
                try:
                    assert handle.remote().result(timeout=30) == "up"
                    outcomes["ok"] += 1
                except Exception:  # noqa: BLE001
                    outcomes["fail"] += 1
                time.sleep(0.02)

        t = threading.Thread(target=traffic)
        t.start()
        try:
            time.sleep(0.5)
            controller = rt.get_actor("serve-controller",
                                           namespace="_serve")
            rt.kill(controller)
            # force refreshes through the outage window: the handle must
            # degrade to its last-known replica set, not fail
            import math

            for _ in range(6):
                handle._last_refresh = -math.inf
                time.sleep(0.5)
        finally:
            stop.set()
            t.join(timeout=60)
        assert outcomes["ok"] >= 20, outcomes
        assert outcomes["fail"] == 0, (
            f"requests failed during the controller outage: {outcomes}")
        assert handle.overload_stats["stale_serves"] >= 1
        # a fresh controller comes up on demand and serves NEW deployments
        @serve.deployment(num_replicas=1, name="PostOutage")
        def hello(_x=None):
            return "hi"

        h2 = serve.run(hello.bind())
        assert h2.remote().result(timeout=60) == "hi"
