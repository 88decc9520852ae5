"""The port's preemption plane (``ray_tpu_torch/gpu/preemption.py`` and
its node-daemon hook-up) against the JAX package's tier-1 cases:
``test_preempt_notice.py`` (the TTL'd notice table, its failover, the
watcher's rearm and proactive publish loop, a seeded wave on the
in-process simnode plane), ``test_elastic_train.py``'s
``test_preemption_watcher_rearm_fires_again`` and ``test_drain.py``'s
watcher and ``testing_preempt_notice`` cases; then both packages' watchers
on one scripted metadata sequence, which must make the same calls in the
same order. The runtime imports no torch, so these run in the pytest
worker; the daemon case starts a port cluster of two nodes.
"""

import asyncio
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import protocol as pb
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.protocol import NodeInfo, ResourceSet
from ray_tpu_torch.util.metrics import reset_registry


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The conftest fixture resets the JAX package's registries; this one
    resets the port's."""
    yield
    GLOBAL_CONFIG.reset()
    chaos.reset()
    reset_registry()


def _node_wire(node_id=None, address="127.0.0.1:1", labels=None,
               resources=None):
    return NodeInfo(
        node_id=node_id or NodeID.from_random(),
        address=address,
        object_store_name="none",
        resources=ResourceSet(resources or {"CPU": 2}),
        labels=labels or {},
    ).to_wire()


# ---------------------------------------------------------------------------
# the notice table: state transitions, TTL, deadline clamping
# ---------------------------------------------------------------------------


def test_notice_enters_preempting_and_ttl_reverts():
    """A notice moves the node to PREEMPTING (delta-versioned, visible in
    get_nodes_delta and get_cluster_load); TTL expiry without a drain
    reverts it to ALIVE — the reversible half of the notice plane."""
    from ray_tpu_torch._private.control_store import ControlStore

    async def run():
        cs = ControlStore()
        w = _node_wire()
        nid = w["node_id"]
        await cs.rpc_register_node(0, {"node": w})
        cursor = (await cs.rpc_get_nodes_delta(0, {"cursor": -1}))["version"]

        r = await cs.rpc_report_preemption_notice(
            0, {"node_id": nid, "deadline_s": 30.0})
        assert r["ok"] and r["state"] == pb.NODE_PREEMPTING
        assert r["deadline_ts"] == pytest.approx(time.time() + 30.0, abs=2.0)
        info = cs.nodes[nid]
        assert info.state == pb.NODE_PREEMPTING
        assert info.drain_reason == pb.DRAIN_REASON_PREEMPTION

        # delta-versioned like every node mutation
        delta = await cs.rpc_get_nodes_delta(0, {"cursor": cursor})
        assert [u["state"] for u in delta["updates"]] == [pb.NODE_PREEMPTING]

        # committed-load surface for the proactive reconciler
        load = await cs.rpc_get_cluster_load(0, {})
        pre = load["preempting"]
        assert len(pre) == 1 and pre[0]["node_id"] == NodeID(nid).hex()
        assert ResourceSet.from_wire(pre[0]["total"]).to_dict() == {"CPU": 2}
        row = [n for n in load["nodes"]
               if n["node_id"] == NodeID(nid).hex()][0]
        assert row["state"] == pb.NODE_PREEMPTING

        # TTL lapse (publisher gone / reclaim cancelled) -> back to ALIVE
        cs.preempt_notices[nid]["expires_ts"] = time.time() - 1.0
        cs._sweep_preempt_notices()
        assert nid not in cs.preempt_notices
        info = cs.nodes[nid]
        assert info.state == pb.NODE_ALIVE
        assert info.drain_reason == "" and info.drain_deadline == 0.0
        load = await cs.rpc_get_cluster_load(0, {})
        assert load["preempting"] == []

    asyncio.run(run())


def test_notice_refresh_never_extends_deadline():
    """Re-publication (the daemon's keepalive cadence) refreshes the TTL
    but the death deadline stays pinned at the FIRST notice's wall-clock
    time — a re-publish must not talk the reconciler into complacency."""
    from ray_tpu_torch._private.control_store import ControlStore

    async def run():
        cs = ControlStore()
        w = _node_wire()
        nid = w["node_id"]
        await cs.rpc_register_node(0, {"node": w})
        r1 = await cs.rpc_report_preemption_notice(
            0, {"node_id": nid, "deadline_s": 5.0})
        expires1 = cs.preempt_notices[nid]["expires_ts"]
        await asyncio.sleep(0.01)
        r2 = await cs.rpc_report_preemption_notice(
            0, {"node_id": nid, "deadline_s": 500.0})
        assert r2["deadline_ts"] == r1["deadline_ts"]  # min(prior, new)
        assert cs.preempt_notices[nid]["expires_ts"] > expires1  # TTL fresh
        # idempotent: the PREEMPTING transition published exactly one delta
        deltas = [d for _, d in cs._node_deltas
                  if d.get("state") == pb.NODE_PREEMPTING]
        assert len(deltas) == 1

    asyncio.run(run())


def test_drain_and_death_supersede_notice():
    """A drain (reconciler or deadline) or a death pops the notice so TTL
    expiry can't revive a node mid-exit; a notice for a DRAINING node is
    a no-op; unknown/dead nodes are refused."""
    from ray_tpu_torch._private.control_store import ControlStore

    async def run():
        cs = ControlStore()
        w1, w2 = _node_wire(), _node_wire()
        for w in (w1, w2):
            await cs.rpc_register_node(0, {"node": w})

        await cs.rpc_report_preemption_notice(
            0, {"node_id": w1["node_id"], "deadline_s": 30.0})
        await cs.rpc_drain_node(0, {"node_id": w1["node_id"],
                                    "reason": pb.DRAIN_REASON_PREEMPTION,
                                    "deadline_s": 5.0})
        assert w1["node_id"] not in cs.preempt_notices
        assert cs.nodes[w1["node_id"]].state == pb.NODE_DRAINING
        # the sweep must not resurrect it
        cs._sweep_preempt_notices()
        assert cs.nodes[w1["node_id"]].state == pb.NODE_DRAINING
        # a late notice against the draining node doesn't regress state
        r = await cs.rpc_report_preemption_notice(
            0, {"node_id": w1["node_id"], "deadline_s": 30.0})
        assert r["ok"] and r["state"] == pb.NODE_DRAINING
        assert w1["node_id"] not in cs.preempt_notices

        await cs.rpc_report_preemption_notice(
            0, {"node_id": w2["node_id"], "deadline_s": 30.0})
        await cs._mark_node_dead(w2["node_id"], "killed")
        assert w2["node_id"] not in cs.preempt_notices

        r = await cs.rpc_report_preemption_notice(
            0, {"node_id": b"\x00" * 28, "deadline_s": 30.0})
        assert not r["ok"]

    asyncio.run(run())


def test_notice_survives_store_failover(tmp_path):
    """The notice is persisted (WAL op + snapshot field): a recovered
    store incarnation resumes the SAME wall-clock deadline/TTL and the
    node is still PREEMPTING — the HA half of the notice plane."""
    from ray_tpu_torch._private.control_store import ControlStore

    GLOBAL_CONFIG.apply_system_config({"control_store_persist": True})

    async def phase1():
        cs = ControlStore(persist_dir=str(tmp_path))
        addr = await cs.start(port=0)
        w = _node_wire()
        await cs.rpc_register_node(0, {"node": w})
        await cs.rpc_report_preemption_notice(
            0, {"node_id": w["node_id"], "deadline_s": 30.0})
        ent = dict(cs.preempt_notices[w["node_id"]])
        await cs.stop()
        return w["node_id"], ent

    nid, ent = asyncio.run(phase1())

    async def phase2():
        cs = ControlStore(persist_dir=str(tmp_path))
        await cs.start(port=0)
        assert cs.preempt_notices.get(nid) == ent
        info = cs.nodes[nid]
        assert info.state == pb.NODE_PREEMPTING
        assert info.drain_reason == pb.DRAIN_REASON_PREEMPTION
        # and the load surface still advertises it to the reconciler
        load = await cs.rpc_get_cluster_load(0, {})
        assert [p["node_id"] for p in load["preempting"]] == [
            NodeID(nid).hex()]
        await cs.stop()

    asyncio.run(phase2())


# ---------------------------------------------------------------------------
# the watcher: rearm regression + proactive publish loop
# ---------------------------------------------------------------------------


def test_watcher_rearm_fires_on_second_notice():
    """Regression (r18 satellite): a watcher that survived one notice
    (reclaim cancelled / drain undrained) must fire again on the NEXT
    reclaim of the same host after rearm() + a fresh run()."""
    from ray_tpu_torch.gpu.preemption import (FakeMetadataTransport,
                                              PreemptionWatcher)

    notices = []

    async def on_notice(reason, deadline_s):
        notices.append((reason, deadline_s))

    async def run():
        transport = FakeMetadataTransport()
        w = PreemptionWatcher(on_notice=on_notice, transport=transport,
                              poll_period_s=0.005, drain_deadline_s=7.5)
        transport.preempt()
        await asyncio.wait_for(w.run(), timeout=2)
        assert w.fired and len(notices) == 1

        # reclaim cancelled; the host survives and is later reclaimed again
        transport.clear()
        w.rearm()
        assert not w.fired
        task = asyncio.ensure_future(w.run())
        await asyncio.sleep(0.02)
        assert not w.fired  # no notice pending -> stays quiet
        transport.schedule_maintenance()
        await asyncio.wait_for(task, timeout=2)
        assert len(notices) == 2
        assert notices[0] == (pb.DRAIN_REASON_PREEMPTION, 7.5)
        assert notices[1][0] == pb.DRAIN_REASON_PREEMPTION
        w.stop()

    # no publish seam wired -> the legacy reactive path runs regardless of
    # the preempt_proactive default
    asyncio.run(run())


def test_watcher_proactive_republishes_through_store_outage():
    """The proactive loop keeps the TTL'd notice fresh, retries through a
    publish failure (store failover mid-notice), and forces the self-drain
    with the REMAINING deadline once the grace point passes."""
    from ray_tpu_torch.gpu.preemption import PreemptionWatcher

    GLOBAL_CONFIG.apply_system_config({
        "preempt_proactive": True,
        "preempt_republish_period_s": 0.02,
        "preempt_drain_grace_frac": 0.5,
    })
    published, drains = [], []

    async def publish(deadline_s):
        if not published:
            published.append(deadline_s)
            raise ConnectionError("store failover in progress")
        published.append(deadline_s)

    async def on_notice(reason, deadline_s):
        drains.append((reason, deadline_s))

    async def run():
        w = PreemptionWatcher(on_notice=on_notice, transport=object(),
                              drain_deadline_s=0.3, publish=publish,
                              drain_started=lambda: False)
        await asyncio.wait_for(w._fire("test"), timeout=5)
        # first publish raised, later ones landed; the loop survived the
        # outage (w.publishes only counts successful sends)
        assert len(published) >= 2 and w.publishes == len(published) - 1
        # remaining deadline shrinks monotonically across re-publishes
        assert published == sorted(published, reverse=True)
        # grace point (0.15s) forced the drain with < the full deadline
        assert w.forced_drains == 1 and len(drains) == 1
        assert drains[0][0] == pb.DRAIN_REASON_PREEMPTION
        assert 0.0 < drains[0][1] <= 0.16

    asyncio.run(run())


def test_watcher_proactive_defers_to_started_drain():
    """Once the control plane starts the drain (replacement capacity
    registered), the publish loop exits WITHOUT forcing a second drain —
    the daemon's normal drain orchestration owns the exit."""
    from ray_tpu_torch.gpu.preemption import PreemptionWatcher

    GLOBAL_CONFIG.apply_system_config({
        "preempt_proactive": True,
        "preempt_republish_period_s": 0.01,
        "preempt_drain_grace_frac": 0.9,
    })
    state = {"draining": False}
    drains = []

    async def publish(deadline_s):
        state["draining"] = True  # control plane reacts to the first notice

    async def on_notice(reason, deadline_s):
        drains.append(reason)

    async def run():
        w = PreemptionWatcher(on_notice=on_notice, transport=object(),
                              drain_deadline_s=5.0, publish=publish,
                              drain_started=lambda: state["draining"])
        await asyncio.wait_for(w._fire("test"), timeout=2)
        assert w.publishes >= 1
        assert w.forced_drains == 0 and drains == []

    asyncio.run(run())


# ---------------------------------------------------------------------------
# seeded correlated wave against an in-process simnode plane (tier-1)
# ---------------------------------------------------------------------------


def test_seeded_wave_proactive_graceful_exits():
    """One compressed correlated wave: half the fleet is spot, a seeded
    draw preempts 100% of the spots inside a 50ms window, and a
    reconciler-shaped drain (filed mid-window, as the autoscaler does once
    replacements register) gets every victim out gracefully before the
    cloud reaper fires. Zero protocol errors, PREEMPTING visible on the
    plane's own node-table view while the window is open."""
    from ray_tpu_torch._private.control_store import ControlStore
    from ray_tpu_torch._private.simnode import SimNodePlane

    GLOBAL_CONFIG.apply_system_config({
        "pubsub_flush_window_ms": 5.0,
        "node_table_delta_sync": True,
        "heartbeat_period_s": 0.05,
    })

    async def run():
        cs = ControlStore()
        addr = await cs.start(port=0)
        plane = SimNodePlane(addr, 6, seed=18, spot_fraction=0.5)
        await plane.start()
        await plane.await_converged(timeout=30)
        assert len(plane.spot_nodes()) == 3

        wave = asyncio.ensure_future(plane.preempt_wave(
            1.0, window_s=0.05, deadline_s=0.6, proactive=True,
            rng_seed=44))

        # reconciler side: once notices land, drain each PREEMPTING node
        # with its remaining deadline (replacement capacity "registered")
        drained = set()
        for _ in range(100):
            await asyncio.sleep(0.01)
            now = time.time()
            for nid, ent in list(cs.preempt_notices.items()):
                if nid in drained:
                    continue
                drained.add(nid)
                await cs.rpc_drain_node(0, {
                    "node_id": nid, "reason": pb.DRAIN_REASON_PREEMPTION,
                    "deadline_s": max(0.1, ent["deadline_ts"] - now)})
            if wave.done():
                break
        res = await asyncio.wait_for(wave, timeout=10)

        assert res["spot_fleet"] == 3 and len(res["victims"]) == 3
        assert res["graceful"] == 3 and res["killed"] == 0
        assert res["first_notice"] is not None
        assert res["first_death"] is None  # nobody hit the reaper
        stats = plane.stats()
        assert stats["protocol_errors"] == []
        # non-spot half untouched
        assert len(plane.alive()) == 3
        await plane.stop()
        await cs.stop()

    asyncio.run(run())


def test_seeded_wave_is_deterministic():
    """Same seed -> same victim set: the chaos campaign is replayable."""
    from ray_tpu_torch._private.control_store import ControlStore
    from ray_tpu_torch._private.simnode import SimNodePlane

    GLOBAL_CONFIG.apply_system_config({
        "pubsub_flush_window_ms": 5.0,
        "node_table_delta_sync": True,
    })

    async def victims_for(seed):
        cs = ControlStore()
        addr = await cs.start(port=0)
        plane = SimNodePlane(addr, 6, seed=7, spot_fraction=0.5)
        await plane.start()
        await plane.await_converged(timeout=30)
        res = await plane.preempt_wave(
            0.67, window_s=0.01, deadline_s=0.05, proactive=False,
            rng_seed=seed)
        await plane.stop()
        await cs.stop()
        return res["victims"]

    async def run():
        a = await victims_for(3)
        b = await victims_for(3)
        c = await victims_for(4)
        assert a == b and len(a) == 2
        assert a != c or True  # different seed may coincide; a==b is the law

    asyncio.run(run())


# ---------------------------------------------------------------------------
# test_elastic_train.py's and test_drain.py's watcher cases
# ---------------------------------------------------------------------------


def test_preemption_watcher_rearm_fires_again():
    """A spot host can be reclaimed more than once across shrink/regrow
    cycles: clear the fake notice, rearm, and a fresh run() must fire a
    second time (the latch is one-shot per run)."""
    from ray_tpu_torch.gpu.preemption import (FakeMetadataTransport,
                                              PreemptionWatcher)

    async def run():
        fake = FakeMetadataTransport()
        fake.preempt()
        notices = []

        async def on_notice(reason, deadline_s):
            notices.append(reason)

        w = PreemptionWatcher(on_notice, transport=fake, poll_period_s=0.01,
                              drain_deadline_s=5.0)
        await asyncio.wait_for(w.run(), timeout=5)
        assert len(notices) == 1 and w.fired
        # reclaim cancelled, capacity survived; later the host is hit again
        fake.clear()
        w.rearm()
        assert not w.fired
        fake.schedule_maintenance()
        await asyncio.wait_for(w.run(), timeout=5)
        assert len(notices) == 2

    asyncio.run(run())


def test_preemption_watcher_fires_once_on_maintenance_event():
    from ray_tpu_torch.gpu.preemption import (FakeMetadataTransport,
                                              PreemptionWatcher)

    async def run():
        fake = FakeMetadataTransport()
        notices = []

        async def on_notice(reason, deadline_s):
            notices.append((reason, deadline_s))

        w = PreemptionWatcher(on_notice, transport=fake,
                              poll_period_s=0.01, drain_deadline_s=7.5)
        task = asyncio.ensure_future(w.run())
        await asyncio.sleep(0.05)
        assert notices == []  # quiet metadata: no notice
        fake.schedule_maintenance()
        await asyncio.wait_for(task, timeout=5)
        assert notices == [(pb.DRAIN_REASON_PREEMPTION, 7.5)]
        assert w.fired and fake.calls > 0

    asyncio.run(run())


def test_preemption_watcher_preempted_flag():
    from ray_tpu_torch.gpu.preemption import (FakeMetadataTransport,
                                              PreemptionWatcher)

    async def run():
        fake = FakeMetadataTransport()
        fake.preempt()
        notices = []

        async def on_notice(reason, deadline_s):
            notices.append(reason)

        w = PreemptionWatcher(on_notice, transport=fake, poll_period_s=0.01)
        await asyncio.wait_for(w.run(), timeout=5)
        assert notices == [pb.DRAIN_REASON_PREEMPTION]

    asyncio.run(run())


def _wait_node_state(cw, node_hex, state, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        reply = cw.run_sync(cw.control.call("get_all_nodes", {}), 10)
        rec = next((n for n in reply["nodes"]
                    if n["node_id"].hex() == node_hex), None)
        if rec is not None and rec["state"] == state:
            return rec
        time.sleep(0.1)
    raise AssertionError(f"node {node_hex[:8]} never reached {state}")


@pytest.mark.parametrize("fault", ["notice", "wave_at_runtime"])
def test_chaos_preempt_notice_self_drains(fault):
    """The seeded preemption faults run the watcher in the port's daemon,
    as in the JAX package: `testing_preempt_notice` aimed at a daemon's
    role at start-up, or `testing_preempt_wave` sent at run time through
    the `chaos_set` RPC to a spot-labelled daemon. The daemon drains
    itself and exits with an expected death record carrying reason
    preemption; the head keeps serving."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.runtime.rpc import RpcClient

    cfg = {"health_check_period_s": 0.25, "health_check_timeout_s": 3.0}
    if fault == "notice":
        # head daemon is daemon1; the node added below is daemon2
        cfg["testing_preempt_notice"] = "daemon2:500:10000"
    GLOBAL_CONFIG.apply_system_config(cfg)
    cluster = Cluster(initialize_head=True, head_resources={"CPU": 2})
    try:
        spot = cluster.add_node(resources={"CPU": 2, "spot": 1},
                                labels={"spot": "true"})
        rt.init(address=cluster.address)
        cw = rt.get_core_worker()
        if fault == "wave_at_runtime":
            async def aim():
                c = RpcClient(spot.address, name="test->spot")
                try:
                    return await c.call("chaos_set", {"config": {
                        "testing_preempt_wave": "1.0:100:10000"}},
                        timeout=30)
                finally:
                    await c.close()

            assert cw.run_sync(aim(), timeout=30)["ok"]
        rec = _wait_node_state(cw, spot.node_id, pb.NODE_DEAD)
        assert rec["death"]["expected"] is True
        assert "preemption" in rec["death"]["reason"]

        @rt.remote(num_cpus=1)
        def f():
            return 42

        assert rt.get(f.remote(), timeout=60) == 42
    finally:
        rt.shutdown()
        cluster.shutdown()


# ---------------------------------------------------------------------------
# parity: both packages' watchers on one scripted metadata sequence
# ---------------------------------------------------------------------------


class _Scripted:
    """A metadata transport that answers from a script and logs each call
    into ``events``: every MAINTENANCE_URL read returns the next value of
    ``maintenance`` (the last one repeating), every PREEMPTED_URL read the
    next of ``preempted``."""

    def __init__(self, urls, events, maintenance, preempted):
        self.urls, self.events = urls, events
        self.script = {urls[0]: list(maintenance), urls[1]: list(preempted)}

    def get(self, url):
        which = "maintenance" if url == self.urls[0] else "preempted"
        vals = self.script[url]
        value = vals.pop(0) if len(vals) > 1 else vals[0]
        self.events.append(("get", which, value))
        return value


SCRIPTS = {
    # reactive: two quiet polls, then a maintenance event
    "maintenance": dict(maintenance=["NONE", "NONE", "MIGRATE_ON_HOST_"
                                     "MAINTENANCE"], preempted=["FALSE"],
                        proactive=False, publish=None),
    # reactive: the preempted flag on the third poll
    "preempted": dict(maintenance=["NONE"], preempted=["FALSE", "FALSE",
                                                       "TRUE"],
                      proactive=False, publish=None),
    # proactive: publishes until the control plane starts the drain
    "drain_started": dict(maintenance=["TERMINATE_ON_HOST_MAINTENANCE"],
                          preempted=["FALSE"], proactive=True,
                          publish="drain_after_3"),
    # proactive: the grace point passes after one publish, so the
    # watcher forces the drain with what is left of the deadline
    "forced_drain": dict(maintenance=["NONE"], preempted=["TRUE"],
                         proactive=True, publish="forced"),
}


def _watcher_events(pkg, script):
    """The calls one package's watcher makes on ``script``: transport
    reads, publishes and drain callbacks, in order."""
    if pkg == "jax":
        from ray_tpu._private.config import GLOBAL_CONFIG as cfg
        from ray_tpu.tpu import preemption as mod
    else:
        cfg = GLOBAL_CONFIG
        from ray_tpu_torch.gpu import preemption as mod
    forced = script["publish"] == "forced"
    cfg.apply_system_config({
        "preempt_proactive": script["proactive"],
        "preempt_republish_period_s": 10.0 if forced else 0.001,
        "preempt_drain_grace_frac": 0.05 if forced else 0.9,
    })
    events = []
    transport = _Scripted((mod.MAINTENANCE_URL, mod.PREEMPTED_URL), events,
                          script["maintenance"], script["preempted"])

    async def on_notice(reason, deadline_s):
        events.append(("drain", reason,
                       deadline_s if not forced else deadline_s <= 2.0))

    async def publish(deadline_s):
        events.append(("publish", deadline_s <= 2.0))

    def drain_started():
        return sum(e[0] == "publish" for e in events) >= 3

    async def run():
        w = mod.PreemptionWatcher(
            on_notice, transport=transport, poll_period_s=0.001,
            drain_deadline_s=2.0,
            publish=publish if script["publish"] else None,
            drain_started=drain_started if script["publish"] else None)
        await asyncio.wait_for(w.run(), timeout=10)
        return w.fired, w.publishes, w.forced_drains

    try:
        return events, asyncio.run(run())
    finally:
        cfg.reset()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_watcher_parity_on_a_scripted_sequence(name):
    script = SCRIPTS[name]
    jax_events, jax_counts = _watcher_events("jax", script)
    port_events, port_counts = _watcher_events("port", script)
    assert port_events == jax_events
    assert port_counts == jax_counts
    drains = [e for e in port_events if e[0] == "drain"]
    publishes = [e for e in port_events if e[0] == "publish"]
    want = {"maintenance": (1, 0), "preempted": (1, 0),
            "drain_started": (0, 3), "forced_drain": (1, 1)}[name]
    assert (len(drains), len(publishes)) == want, port_events
    assert all(e[1] == pb.DRAIN_REASON_PREEMPTION for e in drains)
