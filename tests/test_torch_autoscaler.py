"""The port's autoscaler (``ray_tpu_torch/autoscaler``) against the JAX
package's (``ray_tpu/autoscaler``).

Tier-1: decision parity. Each package's ``Autoscaler`` answers
``_control_call`` from one scripted sequence of ``get_cluster_load``
replies (the JAX package's TPU names, mapped to GPU ones for the port) on
a patched clock, against recording providers; both must make the same
provider calls and control calls in the same order and return equal
``reconcile_once`` dicts. No cluster starts for them. Then the port's
``FakeNodeProvider`` storm on a port control store, and the module's
imports.

``mid`` (``-m mid``): ``tests/test_autoscaler.py``'s six cases on port
clusters with fake ``{"GPU": n}`` resources.
"""

import json
import os
import subprocess
import sys
import time
import types

import pytest

import ray_tpu.autoscaler as jax_as
import ray_tpu_torch.autoscaler as port_as
from ray_tpu._private.protocol import ResourceSet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEAD = "ff" * 16
# node ids the recording providers hand out, in order
IDS = [f"{i:02x}" * 16 for i in range(1, 40)]
WALL0 = 1.7e9


def wire(res):
    return ResourceSet(res).to_wire()


def to_gpu(obj):
    """The JAX package's names as the port spells them: the TPU resource
    and head token, and the pod type."""
    if isinstance(obj, dict):
        return {to_gpu(k): to_gpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_gpu(v) for v in obj)
    if isinstance(obj, str):
        return obj.replace("TPU", "GPU").replace("v5e-8", "H100-8")
    return obj


def row(nid, total, available=None, idle=False, state="ALIVE"):
    return {"node_id": nid, "state": state, "total": wire(total),
            "available": wire(total if available is None else available),
            "pending": 0, "idle": idle}


def load(nodes, pending=(), pending_total=None, pgs=(), jobs=(),
         reported=(), preempting=()):
    return {
        "nodes": list(nodes),
        "pending_resources": [wire(r) for r in pending],
        "pending_total": (len(pending) if pending_total is None
                          else pending_total),
        "pending_pg_bundles": [{"resources": wire(b)} for b in pgs],
        "pending_job_resources": [wire(r) for r in jobs],
        "reported_demand": [wire(r) for r in reported],
        "preempting": list(preempting),
        "delta": False,
    }


class Recorder:
    """A provider that records every call and hands out IDS in order."""

    def __init__(self, log):
        self.log = log
        self._ids = iter(IDS)

    def _handle(self):
        return {"node_id": next(self._ids), "proc": None}

    def create_node(self, resources):
        h = self._handle()
        self.log.append(("create_node", dict(resources), h["node_id"]))
        return h

    def terminate_node(self, handle):
        self.log.append(("terminate_node", handle["node_id"]))

    def node_alive(self, handle):
        return True

    def create_slice(self, pod_type, spec):
        nodes = [self._handle() for _ in range(spec.hosts)]
        name = f"{pod_type}-{nodes[0]['node_id'][:4]}"
        self.log.append(("create_slice", pod_type, spec.hosts,
                         dict(spec.resources_per_host), name))
        return {"slice_name": name, "pod_type": pod_type, "nodes": nodes}

    def terminate_slice(self, handle):
        self.log.append(("terminate_slice", handle["slice_name"]))


class BatchRecorder(Recorder):
    """A provider with the batched launch surface (the storm path)."""

    def create_nodes(self, resources, count):
        hs = [self._handle() for _ in range(count)]
        self.log.append(("create_nodes", dict(resources), count,
                         [h["node_id"] for h in hs]))
        return hs


def run_script(mod, monkeypatch, config, steps, provider_cls, gpu):
    """Drive ``mod.Autoscaler`` through ``steps`` (each ``(load, seconds
    the clock then advances)``): its provider calls, control calls and
    ``reconcile_once`` results, in order."""
    clock = {"t": 1000.0}
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock["t"],
        time=lambda: WALL0 + clock["t"]))
    log, replies = [], iter(steps)
    results = []

    class Scripted(mod.Autoscaler):
        def _control_call(self, method, payload, timeout=30.0):
            log.append(("control", method, payload))
            if method != "get_cluster_load":
                return {}
            reply, _ = next(replies)
            return to_gpu(reply) if gpu else reply

    cfg = to_gpu(config) if gpu else dict(config)
    if "slice_types" in cfg:
        cfg["slice_types"] = {k: mod.SliceSpec(**v)
                              for k, v in cfg["slice_types"].items()}
    scaler = Scripted(provider_cls(log), mod.AutoscalingConfig(**cfg))
    for _, advance in steps:
        results.append(scaler.reconcile_once())
        clock["t"] += advance
    return log, results


BASE = dict(min_workers=0, max_workers=4, worker_resources={"CPU": 2.0},
            idle_timeout_s=5.0, poll_period_s=1.0, demand_driven=True,
            preempt_proactive=True)
BUSY_HEAD = row(HEAD, {"CPU": 2.0}, {"CPU": 0.0})
IDLE_HEAD = row(HEAD, {"CPU": 2.0}, idle=True)


def _idle_cycle(worker_total, **extra):
    """One worker launched for a pending shape, registered, idle past the
    timeout: drained, then terminated."""
    w = IDS[0]
    return [
        (load([BUSY_HEAD], pending=[{"CPU": 1.0}], **extra), 1.0),
        (load([BUSY_HEAD, row(w, worker_total, {"CPU": 1.0})], **extra),
         1.0),
        (load([IDLE_HEAD, row(w, worker_total, idle=True)], **extra), 6.0),
        (load([IDLE_HEAD, row(w, worker_total, idle=True)], **extra), 1.0),
        (load([IDLE_HEAD, row(w, worker_total, idle=True,
                              state="DRAINING")], **extra), 1.0),
        (load([IDLE_HEAD], **extra), 1.0),
    ]


def _preempt_steps():
    victim = IDS[30]
    committed = {"CPU": 10000}  # 1 CPU, wire units
    notice = {"node_id": victim, "committed": committed,
              "deadline_ts": WALL0 + 1000.0 + 30.0}
    nodes = [BUSY_HEAD, row(victim, {"CPU": 2.0}, {"CPU": 1.0},
                            state="PREEMPTING")]
    return [
        (load(nodes, preempting=[notice]), 1.0),
        (load(nodes, preempting=[notice]), 1.0),
        (load(nodes + [row(IDS[0], {"CPU": 2.0}, idle=True)],
              preempting=[notice]), 1.0),
        (load(nodes + [row(IDS[0], {"CPU": 2.0}, idle=True)],
              preempting=[notice]), 1.0),
    ]


# case id -> (config overrides, steps, provider, the JAX run's calls that
# show the case did what it is named for: {kind: count})
CASES = {
    "scale_up_on_pending_shapes": (
        {}, [(load([BUSY_HEAD], pending=[{"CPU": 1.0}] * 3), 1.0),
             (load([BUSY_HEAD], pending=[{"CPU": 1.0}] * 3), 1.0),
             (load([BUSY_HEAD, row(IDS[0], {"CPU": 2.0}, {"CPU": 0.0}),
                    row(IDS[1], {"CPU": 2.0}, {"CPU": 1.0})]), 1.0)],
        Recorder, {"create_node": 2}),
    "max_workers_cap": (
        dict(max_workers=1, worker_resources={"CPU": 1.0}),
        [(load([BUSY_HEAD], pending=[{"CPU": 1.0}] * 8), 1.0),
         (load([BUSY_HEAD, row(IDS[0], {"CPU": 1.0}, {"CPU": 0.0})],
               pending=[{"CPU": 1.0}] * 7), 1.0),
         (load([BUSY_HEAD, row(IDS[0], {"CPU": 1.0}, {"CPU": 0.0})],
               pending=[{"CPU": 1.0}] * 6), 1.0)],
        Recorder, {"create_node": 1}),
    "idle_drain_terminate": (
        {}, _idle_cycle({"CPU": 2.0}), Recorder,
        {"create_node": 1, "drain_node": 1, "unregister_node": 1,
         "terminate_node": 1}),
    "undrain_when_demand_returns": (
        {}, _idle_cycle({"CPU": 2.0})[:4] + [
            (load([BUSY_HEAD, row(IDS[0], {"CPU": 2.0}, idle=True,
                                  state="DRAINING")],
                  pending=[{"CPU": 1.0}]), 1.0),
            (load([BUSY_HEAD, row(IDS[0], {"CPU": 2.0}, {"CPU": 1.0})]),
             1.0)],
        Recorder, {"create_node": 1, "drain_node": 1, "undrain_node": 1}),
    "min_workers_floor": (
        dict(min_workers=1, max_workers=1),
        [(load([IDLE_HEAD]), 1.0),
         (load([IDLE_HEAD, row(IDS[0], {"CPU": 2.0}, idle=True)]), 6.0),
         (load([IDLE_HEAD, row(IDS[0], {"CPU": 2.0}, idle=True)]), 6.0),
         (load([IDLE_HEAD, row(IDS[0], {"CPU": 2.0}, idle=True)]), 1.0)],
        Recorder, {"create_node": 1, "drain_node": 0}),
    "infeasible_shape": (
        {}, [(load([IDLE_HEAD], pending=[{"CPU": 8.0}]), 1.0),
             (load([IDLE_HEAD], pending=[{"CPU": 8.0}]), 1.0)],
        Recorder, {"create_node": 0}),
    "shapes_capped_out": (
        {}, [(load([BUSY_HEAD], pending_total=5), 1.0),
             (load([BUSY_HEAD], pending_total=5), 1.0)],
        Recorder, {"create_node": 1}),
    "job_queue_demand": (
        {}, [(load([BUSY_HEAD], jobs=[{"CPU": 2.0}],
                   reported=[{"CPU": 2.0}]), 1.0),
             (load([BUSY_HEAD], jobs=[{"CPU": 2.0}],
                   reported=[{"CPU": 2.0}]), 1.0)],
        Recorder, {"create_node": 2}),
    "job_queue_demand_reactive": (
        dict(demand_driven=False),
        [(load([BUSY_HEAD], jobs=[{"CPU": 2.0}],
               reported=[{"CPU": 2.0}]), 1.0)],
        Recorder, {"create_node": 0}),
    "head_token_creates_slices": (
        dict(max_workers=0, max_slices=2, slice_types={"v5e-8": dict(
            hosts=2, resources_per_host={"CPU": 1.0, "TPU": 4.0})}),
        [(load([IDLE_HEAD], pgs=[{"TPU-v5e-8-head": 1.0}] * 3), 1.0),
         (load([IDLE_HEAD], pgs=[{"TPU-v5e-8-head": 1.0}] * 3), 1.0),
         (load([IDLE_HEAD] + [
             row(IDS[i], {"CPU": 1.0, "TPU": 4.0}) for i in range(4)],
             pgs=[{"TPU-v5e-8-head": 1.0}]), 1.0)],
        Recorder, {"create_slice": 2}),
    "preempt_replacement_proactive": (
        {}, _preempt_steps(), Recorder,
        {"create_node": 1, "drain_node": 1}),
    "preempt_replacement_reactive": (
        dict(preempt_proactive=False), _preempt_steps(), Recorder,
        {"create_node": 0, "drain_node": 0}),
    "batched_create_nodes_storm": (
        dict(max_workers=10, worker_resources={"CPU": 1.0}),
        [(load([BUSY_HEAD], pending=[{"CPU": 1.0}] * 6), 1.0),
         (load([BUSY_HEAD], pending=[{"CPU": 1.0}] * 6), 1.0)],
        BatchRecorder, {"create_nodes": 1, "create_node": 0}),
}


def _kinds(log):
    counts = {}
    for entry in log:
        kind = entry[1] if entry[0] == "control" else entry[0]
        counts[kind] = counts.get(kind, 0) + 1
    return counts


@pytest.mark.parametrize("case", list(CASES))
def test_decisions_match_jax(case, monkeypatch):
    overrides, steps, provider_cls, expect = CASES[case]
    config = dict(BASE, **overrides)
    jax_log, jax_results = run_script(jax_as, monkeypatch, config, steps,
                                      provider_cls, gpu=False)
    port_log, port_results = run_script(port_as, monkeypatch, config,
                                        steps, provider_cls, gpu=True)
    kinds = _kinds(jax_log)
    for kind, n in expect.items():
        assert kinds.get(kind, 0) == n, (kind, kinds)
    assert port_log == to_gpu(jax_log)
    assert port_results == jax_results


def test_fake_provider_storm_on_a_port_control_store():
    """The port's FakeNodeProvider under the real reconciler (standalone,
    its own RPC client): 8 nodes of pushed demand come up in one batched
    launch and drain back to none once the demand is withdrawn, with no
    protocol error."""
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch.autoscaler.fake_provider import FakeNodeProvider
    from ray_tpu_torch.runtime.rpc import RpcClient
    import asyncio

    session_dir = node_mod.new_session_dir()
    cs_proc, addr = node_mod.start_control_store(session_dir)
    provider = FakeNodeProvider(addr, seed=7)
    batches = []
    create_nodes = provider.create_nodes
    provider.create_nodes = lambda r, n: batches.append(n) or create_nodes(
        r, n)
    scaler = port_as.Autoscaler(provider, port_as.AutoscalingConfig(
        min_workers=0, max_workers=8, worker_resources={"CPU": 4.0},
        idle_timeout_s=1.0, poll_period_s=0.3, demand_driven=True),
        control_address=addr).start()

    async def demand(shapes):
        c = RpcClient(addr, name="test-storm")
        await c.connect()
        try:
            await c.call("report_demand", {
                "key": "storm", "shapes": shapes, "ttl_s": 600.0})
        finally:
            await c.close()

    def wait_alive(pred, timeout=60):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred(provider.stats()["alive"]):
                return True
            time.sleep(0.2)
        return False

    try:
        asyncio.run(demand([{"CPU": 4.0}] * 8))
        assert wait_alive(lambda a: a == 8), provider.stats()
        assert batches == [8]
        asyncio.run(demand([]))
        assert wait_alive(lambda a: a == 0), provider.stats()
        assert scaler.workers == []
        assert provider.protocol_errors() == []
    finally:
        scaler.stop()
        provider.shutdown()
        node_mod.kill_process(cs_proc, force=True)


def test_autoscaler_imports_neither_torch_nor_jax():
    code = ("import sys\n"
            "import ray_tpu_torch.autoscaler, ray_tpu_torch.autoscaler.gcp\n"
            "import ray_tpu_torch.autoscaler.launcher\n"
            "import ray_tpu_torch.autoscaler.fake_provider\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu')]\n"
            "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", "import json\n" + code],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []


# ---------------------------------------------------------------------------
# mid: tests/test_autoscaler.py on port clusters
# ---------------------------------------------------------------------------


@pytest.fixture()
def port_init():
    import ray_tpu_torch as rt

    info = rt.init(num_cpus=2)
    yield info
    rt.shutdown()


@pytest.mark.mid
def test_scale_up_on_demand_and_down_on_idle(port_init):
    import ray_tpu_torch as rt

    provider = port_as.LocalNodeProvider(
        port_init["address"], port_init["session_dir"])
    scaler = port_as.Autoscaler(provider, port_as.AutoscalingConfig(
        min_workers=0, max_workers=2,
        worker_resources={"CPU": 2.0, "GPU": 1.0},
        idle_timeout_s=3.0, poll_period_s=0.5,
    )).start()
    try:
        @rt.remote(num_gpus=1)
        def hold(sec):
            import time as t

            t.sleep(sec)
            return "done"

        # 3 one-GPU holds on a head with no GPU: their leases pend, the
        # demand shows in heartbeats, the scaler adds GPU workers
        refs = [hold.remote(8) for _ in range(3)]
        deadline = time.time() + 40
        while time.time() < deadline and len(scaler.workers) < 2:
            time.sleep(0.5)
        assert len(scaler.workers) >= 1, "autoscaler never scaled up"
        assert rt.get(refs, timeout=120) == ["done"] * 3
        deadline = time.time() + 40
        while time.time() < deadline and scaler.workers:
            time.sleep(0.5)
        assert scaler.workers == [], "idle nodes never terminated"
        nodes = [n for n in rt.nodes() if n["state"] == "ALIVE"]
        assert len(nodes) == 1  # only the head remains
    finally:
        scaler.stop()


@pytest.mark.mid
def test_max_workers_cap(port_init):
    import ray_tpu_torch as rt

    provider = port_as.LocalNodeProvider(
        port_init["address"], port_init["session_dir"])
    scaler = port_as.Autoscaler(provider, port_as.AutoscalingConfig(
        min_workers=0, max_workers=1,
        worker_resources={"CPU": 1.0, "GPU": 1.0},
        idle_timeout_s=60.0, poll_period_s=0.5,
    )).start()
    try:
        @rt.remote(num_gpus=1)
        def hold(sec):
            import time as t

            t.sleep(sec)
            return 1

        refs = [hold.remote(2) for _ in range(4)]
        time.sleep(4)
        assert len(scaler.workers) <= 1
        assert sum(rt.get(refs, timeout=120)) == 4
    finally:
        scaler.stop()


@pytest.mark.mid
def test_drained_node_undrains_when_demand_returns(port_init):
    import ray_tpu_torch as rt

    provider = port_as.LocalNodeProvider(
        port_init["address"], port_init["session_dir"])
    scaler = port_as.Autoscaler(provider, port_as.AutoscalingConfig(
        min_workers=0, max_workers=1,
        worker_resources={"CPU": 2.0, "GPU": 4.0},
        idle_timeout_s=0.5, poll_period_s=0.3,
    ))
    try:
        @rt.remote(num_gpus=1)
        def on_worker():
            return "ran"

        ref = on_worker.remote()
        deadline = time.time() + 60
        done = False
        while time.time() < deadline and not done:
            scaler.reconcile_once()
            try:
                assert rt.get(ref, timeout=2) == "ran"
                done = True
            except rt.GetTimeoutError:
                pass
        assert done, "scale-up never satisfied the task"

        deadline = time.time() + 30
        while time.time() < deadline and not scaler._draining:
            scaler.reconcile_once()
            time.sleep(0.4)
        assert scaler._draining, "idle node was never drained"

        held_node = scaler.workers[0]["node_id"]
        ref2 = on_worker.remote()
        time.sleep(2.5)  # pending/infeasible demand must reach a heartbeat
        deadline = time.time() + 45
        while time.time() < deadline and scaler._draining:
            scaler.reconcile_once()
            time.sleep(0.5)
        assert not scaler._draining, "drained node was never returned"
        done2 = False
        deadline = time.time() + 60
        while time.time() < deadline and not done2:
            scaler.reconcile_once()
            try:
                assert rt.get(ref2, timeout=2) == "ran"
                done2 = True
            except rt.GetTimeoutError:
                pass
        assert done2
        assert [w["node_id"] for w in scaler.workers] == [held_node]
    finally:
        scaler.stop()


@pytest.mark.mid
def test_min_workers_node_is_never_drained(port_init):
    import ray_tpu_torch as rt

    provider = port_as.LocalNodeProvider(
        port_init["address"], port_init["session_dir"])
    scaler = port_as.Autoscaler(provider, port_as.AutoscalingConfig(
        min_workers=1, max_workers=1,
        worker_resources={"CPU": 2.0, "GPU": 4.0},
        idle_timeout_s=0.3, poll_period_s=0.3,
    ))
    try:
        @rt.remote(num_gpus=1)
        def on_worker():
            return "ran"

        ref = on_worker.remote()
        deadline = time.time() + 60
        done = False
        while time.time() < deadline and not done:
            scaler.reconcile_once()
            try:
                assert rt.get(ref, timeout=2) == "ran"
                done = True
            except rt.GetTimeoutError:
                pass
        assert done
        for _ in range(5):
            scaler.reconcile_once()
            time.sleep(0.3)
        assert not scaler._draining
        assert len(scaler.workers) == 1
        assert rt.get(on_worker.remote(), timeout=60) == "ran"
    finally:
        scaler.stop()


@pytest.mark.mid
def test_infeasible_demand_triggers_scale_up(port_init):
    import ray_tpu_torch as rt

    provider = port_as.LocalNodeProvider(
        port_init["address"], port_init["session_dir"])
    scaler = port_as.Autoscaler(provider, port_as.AutoscalingConfig(
        min_workers=0, max_workers=1,
        worker_resources={"CPU": 4.0, "GPU": 2.0},
        idle_timeout_s=60.0, poll_period_s=0.5,
    )).start()
    try:
        @rt.remote(num_cpus=4, num_gpus=2)  # infeasible on the head
        def wide():
            return "wide"

        assert rt.get(wide.remote(), timeout=90) == "wide"
        assert len(scaler.workers) == 1
    finally:
        scaler.stop()


@pytest.mark.mid
def test_domain_aware_scale_up_schedules_domain_pg(port_init):
    """A placement group for 2 NVLink domains is infeasible (no GPU nodes)
    -> the autoscaler provisions whole labeled domains -> the PG schedules
    and resolves the domain names."""
    from ray_tpu_torch.gpu.slice import slice_placement_group
    from ray_tpu_torch.util.state import list_nodes

    provider = port_as.SliceNodeProvider(
        port_init["address"], port_init["session_dir"])
    scaler = port_as.Autoscaler(provider, port_as.AutoscalingConfig(
        min_workers=0, max_workers=0,
        idle_timeout_s=3600, poll_period_s=0.3,
        slice_types={"H100-8": port_as.SliceSpec(
            hosts=2, resources_per_host={"CPU": 1.0, "GPU": 4.0})},
        max_slices=2,
    )).start()
    try:
        spg = slice_placement_group(pod_type="H100-8", num_slices=2,
                                    gpus_per_host=4, hosts_per_slice=2)
        assert spg.ready(timeout=120), "domain PG never became ready"
        labeled = [n for n in list_nodes()
                   if n["labels"].get("gpu-pod-type") == "H100-8"]
        assert len(labeled) == 4  # 2 domains x 2 hosts
        names = {n["labels"]["gpu-domain-name"] for n in labeled}
        assert len(names) == 2
        assert len(spg._slice_names) == 2 and all(spg._slice_names)
        spg.remove()
    finally:
        scaler.stop()
