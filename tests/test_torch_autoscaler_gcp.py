"""The port's GCE provider and YAML launcher
(``ray_tpu_torch/autoscaler/gcp.py``, ``launcher.py``) against the JAX
package's, driven offline through each package's ``FakeGcpTransport``.

Tier-1 (no cluster): the REST surface of GCE workers and NVLink domains;
``create_node``'s request body against the JAX package's; the host-count
``ValueError`` of both; ``load_cluster_config`` and ``_autoscaling_config``
of both on one YAML; the launcher's refusals; and the cloud-worker
findings (ROADMAP Queue 3), held on the JAX package and repaired in the
port.

``mid`` (``-m mid``): ``tests/test_autoscaler_gcp.py``'s two cluster cases
on port clusters: a domain provisioned through the fake cloud for a
pending domain placement group, and the YAML launcher up and down.
"""

import itertools
import json
import types

import pytest
import yaml

import ray_tpu.autoscaler as jax_as
import ray_tpu.autoscaler.gcp as jax_gcp
import ray_tpu.autoscaler.launcher as jax_launcher
import ray_tpu_torch.autoscaler as port_as
import ray_tpu_torch.autoscaler.gcp as port_gcp
import ray_tpu_torch.autoscaler.launcher as port_launcher
from ray_tpu._private.protocol import ResourceSet


def _meta(inst):
    return {i["key"]: i["value"] for i in inst["metadata"]["items"]}


@pytest.fixture(autouse=True)
def _no_op_wait(monkeypatch, request):
    """The providers poll an operation every 2 s; offline the fake's
    operations finish by polls, not by time, so the tier-1 cases skip the
    sleep (the clock itself stays real)."""
    if request.node.get_closest_marker("mid"):
        return
    import time

    for gcp in (jax_gcp, port_gcp):
        monkeypatch.setattr(gcp, "time", types.SimpleNamespace(
            monotonic=time.monotonic, time=time.time,
            sleep=lambda s: None))


def test_provider_rest_surface():
    """Provider unit: worker and domain lifecycles issue the right GCE REST
    calls and poll operations to done."""
    t = port_gcp.FakeGcpTransport(op_latency=2)
    p = port_gcp.GpuVmNodeProvider(
        project="proj", zone="us-central1-a",
        control_address="127.0.0.1:1", transport=t, cluster_name="t")

    h = p.create_node({"CPU": 4.0, "GPU": 1.0})
    inst = t.instances[h["name"]]
    assert inst["labels"]["rt-kind"] == "worker"
    assert inst["scheduling"] == {"onHostMaintenance": "TERMINATE"}
    meta = _meta(inst)
    assert meta["rt-control-address"] == "127.0.0.1:1"
    assert json.loads(meta["rt-resources"]) == {"CPU": 4.0, "GPU": 1.0}
    p.terminate_node(h)
    assert not t.instances
    cpu = p.create_node({"CPU": 4.0})
    assert "scheduling" not in t.instances[cpu["name"]]
    p.terminate_node(cpu)

    s = p.create_slice("H100-8", port_as.SliceSpec(
        hosts=1, resources_per_host={"CPU": 8.0, "GPU": 8.0}))
    (name, inst), = t.instances.items()
    assert inst["machineType"].endswith("/machineTypes/a3-highgpu-8g")
    assert inst["labels"]["rt-kind"] == "domain"
    assert inst["scheduling"] == {"onHostMaintenance": "TERMINATE"}
    meta = _meta(inst)
    assert meta["rt-hosts"] == "1" and meta["rt-host-index"] == "0"
    assert meta["rt-slice-name"] == s["slice_name"]
    assert meta["rt-pod-type"] == "H100-8"
    assert json.loads(meta["rt-resources"]) == {"CPU": 8.0, "GPU": 8.0}
    assert [n["node_id"] for n in s["nodes"]] == [f"{s['slice_name']}/0"]
    assert all(n["proc"].poll() is None for n in s["nodes"])
    p.terminate_slice(s)
    assert not t.instances

    rack = p.create_slice("GB200-72", port_as.SliceSpec(
        hosts=18, resources_per_host={"CPU": 8.0, "GPU": 4.0}))
    assert len(t.instances) == 18 and len(rack["nodes"]) == 18
    assert {_meta(i)["rt-host-index"] for i in t.instances.values()} == {
        str(h) for h in range(18)}
    assert {i["machineType"].rsplit("/", 1)[-1]
            for i in t.instances.values()} == {"a4x-highgpu-4g"}
    p.terminate_slice(rack)
    assert not t.instances
    # an unknown pod type passes through as the machine type
    odd = p.create_slice("g2-standard-4", port_as.SliceSpec(hosts=1))
    assert t.instances[odd["nodes"][0]["name"]]["machineType"].endswith(
        "/g2-standard-4")
    p.terminate_slice(odd)
    # every create/delete polled its operation twice (latency=2): 2 + 2
    # workers, 2 + 36 + 2 domain hosts, an insert and a delete each
    ops = [u for m, u in t.calls if "/operations/" in u]
    assert len(ops) == 2 * 2 * (2 + 1 + 18 + 1)
    # each instance was read back RUNNING after its insert
    gets = [u for m, u in t.calls if m == "GET" and "/operations/" not in u]
    assert len(gets) == 1 + 18 + 1


def _fresh_counters(monkeypatch):
    monkeypatch.setattr(jax_gcp.TpuVmNodeProvider, "_counter",
                        itertools.count(1))
    monkeypatch.setattr(port_gcp.GpuVmNodeProvider, "_counter",
                        itertools.count(1))


@pytest.mark.parametrize("resources", [
    {"CPU": 4.0}, {"CPU": 8.0, "GPU": 1.0}], ids=["cpu", "gpu"])
def test_create_node_body_is_jaxs(resources, monkeypatch):
    """The worker VM request, field for field the JAX package's for the
    same arguments, plus GCE's GPU scheduling field when the resources
    ask for a GPU."""
    _fresh_counters(monkeypatch)
    tj, tp = jax_gcp.FakeGcpTransport(), port_gcp.FakeGcpTransport()
    kw = dict(project="proj", zone="us-central1-a",
              control_address="10.0.0.2:6379", cluster_name="c",
              machine_type="a3-highgpu-1g")
    hj = jax_gcp.TpuVmNodeProvider(transport=tj, **kw).create_node(
        {k.replace("GPU", "TPU"): v for k, v in resources.items()})
    hp = port_gcp.GpuVmNodeProvider(transport=tp, **kw).create_node(
        resources)
    assert hj["name"] == hp["name"] and hj["node_id"] == hp["node_id"]
    body_j, body_p = dict(tj.instances[hj["name"]]), dict(
        tp.instances[hp["name"]])
    sched = body_p.pop("scheduling", None)
    assert sched == ({"onHostMaintenance": "TERMINATE"}
                     if "GPU" in resources else None)
    meta_j, meta_p = _meta(body_j), _meta(body_p)
    assert json.loads(meta_p.pop("rt-resources")) == resources
    assert json.loads(meta_j.pop("rt-resources")) == {
        k.replace("GPU", "TPU"): v for k, v in resources.items()}
    assert meta_p == meta_j
    body_j.pop("metadata"), body_p.pop("metadata")
    assert body_p == body_j
    assert tp.calls == tj.calls


def test_host_count_is_checked_as_in_jax():
    for gcp, pod, hosts in ((jax_gcp, "v5e-16", 4),
                            (port_gcp, "GB200-72", 18)):
        mod = jax_as if gcp is jax_gcp else port_as
        cls = getattr(gcp, "TpuVmNodeProvider", None) or gcp.GpuVmNodeProvider
        t = gcp.FakeGcpTransport()
        p = cls(project="proj", zone="z", control_address="a:1",
                transport=t)
        with pytest.raises(ValueError, match=f"{hosts} hosts"):
            p.create_slice(pod, mod.SliceSpec(hosts=2))
        assert t.calls == []


YAML = """\
cluster_name: demo
provider:
  type: {ptype}
  project: proj
  zone: us-central1-a
  machine_type: a3-highgpu-1g
  runtime_version: tpu-ubuntu2204-base
head:
  resources: {{CPU: 4}}
  labels: {{zone: head}}
workers:
  resources: {{CPU: 4, TPU: 1}}
  min_workers: 1
  max_workers: 3
  idle_timeout_s: 30
slice_types:
  v5e-16:
    hosts: 4
    resources_per_host: {{CPU: 8, TPU: 4}}
  v5e-8: {{}}
max_slices: 2
"""


def _to_gpu(text):
    return text.replace("TPU: ", "GPU: ").replace("v5e-16", "H100-16") \
        .replace("v5e-8", "H100-8")


@pytest.mark.parametrize("ptype", ["local", "gcp"])
def test_launcher_config_matches_jax(ptype, tmp_path):
    """load_cluster_config and _autoscaling_config of both packages on one
    YAML (TPU names mapped to GPU ones): the same config, the same
    autoscaling settings, the same SliceSpec defaults; the provider each
    builds (runtime_version accepted, unused by the port)."""
    (tmp_path / "j.yaml").write_text(YAML.format(ptype=ptype))
    (tmp_path / "p.yaml").write_text(_to_gpu(YAML.format(ptype=ptype)))
    cj = jax_launcher.load_cluster_config(str(tmp_path / "j.yaml"))
    cp = port_launcher.load_cluster_config(str(tmp_path / "p.yaml"))
    assert cp == yaml.safe_load(_to_gpu(yaml.safe_dump(cj)))
    aj = jax_launcher._autoscaling_config(cj)
    ap = port_launcher._autoscaling_config(cp)
    for f in ("min_workers", "max_workers", "idle_timeout_s", "max_slices",
              "poll_period_s", "demand_driven", "preempt_proactive"):
        assert getattr(ap, f) == getattr(aj, f), f
    assert ap.worker_resources == {"CPU": 4, "GPU": 1}
    assert aj.worker_resources == {"CPU": 4, "TPU": 1}
    assert ap.slice_types["H100-16"] == port_as.SliceSpec(
        hosts=4, resources_per_host={"CPU": 8, "GPU": 4})
    # a domain type with no keys takes the defaults: 2 hosts as in JAX,
    # one GPU a host where JAX's gives 4 TPU chips
    assert aj.slice_types["v5e-8"].hosts == ap.slice_types["H100-8"].hosts
    assert ap.slice_types["H100-8"].resources_per_host == {
        "CPU": 1.0, "GPU": 1.0}
    pj = jax_launcher._build_provider(cj, "a:1", str(tmp_path))
    pp = port_launcher._build_provider(cp, "a:1", str(tmp_path))
    if ptype == "local":
        assert isinstance(pj, jax_as.SliceNodeProvider)
        assert isinstance(pp, port_as.SliceNodeProvider)
    else:
        assert isinstance(pp, port_gcp.GpuVmNodeProvider)
        for f in ("project", "zone", "control_address", "machine_type",
                  "cluster_name"):
            assert getattr(pp, f) == getattr(pj, f), f


@pytest.mark.parametrize("launcher", [jax_launcher, port_launcher],
                         ids=["jax", "port"])
def test_launcher_rejects_bad_config(launcher, tmp_path):
    """JAX's test_launcher_rejects_bad_config cases, on both packages: a
    config without cluster_name, and a gcp provider without a project
    (refused when the provider is built, before any cloud call)."""
    p = tmp_path / "bad.yaml"
    p.write_text("provider: {type: local}\n")
    with pytest.raises(ValueError, match="cluster_name"):
        launcher.load_cluster_config(str(p))
    p2 = tmp_path / "bad2.yaml"
    p2.write_text("cluster_name: x\nprovider: {type: gcp}\n")
    with pytest.raises(ValueError, match="project"):
        launcher._build_provider(launcher.load_cluster_config(str(p2)),
                                 "a:1", str(tmp_path))
    p3 = tmp_path / "bad3.yaml"
    p3.write_text("cluster_name: x\nprovider: {type: aws}\n")
    with pytest.raises(ValueError, match="unknown provider"):
        launcher._build_provider(launcher.load_cluster_config(str(p3)),
                                 "a:1", str(tmp_path))


def _wire(res):
    return ResourceSet(res).to_wire()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cloud_worker_findings(pkg, monkeypatch):
    """The GCP findings of ROADMAP Queue 3: held on the JAX package, and
    repaired in the port (``_port_cloud_repair``).

    1. JAX's GCP provider has no ``node_alive`` (it is no ``NodeProvider``),
       so once a worker exists every ``reconcile_once`` raises
       AttributeError at the prune (the background loop logs it and
       decides nothing more).
    2. With ``node_alive`` supplied (NodeProvider's default), a cloud
       worker's handle still carries node_id = its instance name, while the
       daemon its VM boots registers under a node id of its own. No node
       row carries the instance name, so the worker counts as a launching
       bin forever and absorbs new demand, and scale-in never drains or
       terminates it, however long the node it booted stays idle."""
    if pkg == "port":
        _port_cloud_repair(monkeypatch)
        return
    mod, gcp, res = jax_as, jax_gcp, "TPU"
    cls = gcp.TpuVmNodeProvider
    clock = {"t": 100.0}
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock["t"], time=lambda: 1.7e9 + clock["t"]))
    head, booted = "ff" * 16, "0a" * 16
    worker = {"CPU": 2.0, res: 1.0}

    def load(nodes, pending=()):
        return {"nodes": nodes, "pending_resources": [_wire(r)
                                                      for r in pending],
                "pending_total": len(pending), "delta": False}

    def row(nid, idle):
        return {"node_id": nid, "state": "ALIVE", "total": _wire(worker),
                "available": _wire(worker if idle else {"CPU": 2.0}),
                "idle": idle}

    idle_head = {"node_id": head, "state": "ALIVE",
                 "total": _wire({"CPU": 2.0}),
                 "available": _wire({"CPU": 2.0}), "idle": True}
    script = iter([load([idle_head], pending=[{res: 1.0}])]
                  + [load([idle_head, row(booted, idle=True)])] * 6)
    calls = []

    class Scripted(mod.Autoscaler):
        def _control_call(self, method, payload, timeout=30.0):
            calls.append(method)
            return next(script) if method == "get_cluster_load" else {}

    t = gcp.FakeGcpTransport(op_latency=0)
    provider = cls(project="p", zone="z", control_address="a:1",
                   transport=t)
    scaler = Scripted(provider, mod.AutoscalingConfig(
        min_workers=0, max_workers=2, worker_resources=worker,
        idle_timeout_s=1.0, poll_period_s=1.0))
    scaler.reconcile_once()
    assert len(scaler.workers) == 1 and len(t.instances) == 1
    assert not hasattr(provider, "node_alive")
    with pytest.raises(AttributeError, match="node_alive"):
        scaler.reconcile_once()

    provider.node_alive = lambda handle: True
    name = scaler.workers[0]["node_id"]
    assert name == scaler.workers[0]["name"] != booted
    for _ in range(5):  # the booted node idles far past the timeout
        clock["t"] += 10.0
        out = scaler.reconcile_once()
        assert out["terminated"] == 0
    assert "drain_node" not in calls and "unregister_node" not in calls
    assert len(t.instances) == 1 and len(scaler.workers) == 1
    # the phantom bin absorbs a new worker-sized shape: nothing launches
    assert scaler._unmet_worker_need(load(
        [idle_head, row(booted, idle=False)],
        pending=[{res: 1.0}])) == 0


def _port_cloud_repair(monkeypatch):
    """The port's repair of both findings, on one scripted store: the
    provider's ``node_alive`` reads the instance, and a daemon labelled
    with its instance name (``gcp.INSTANCE_LABEL``, as a VM's startup
    script labels it) gives the handle its node id. So a worker counts as
    a launching bin only until its daemon registers; it is pruned only
    when its instance is gone; an idle booted worker drains and terminates
    through ``terminate_node``, and an idle booted domain through
    ``terminate_slice``."""
    clock = {"t": 100.0}
    monkeypatch.setattr(port_as, "time", types.SimpleNamespace(
        monotonic=lambda: clock["t"], time=lambda: 1.7e9 + clock["t"]))
    head = "ff" * 16
    worker = {"CPU": 2.0, "GPU": 1.0}
    host = {"CPU": 1.0, "GPU": 8.0}
    label = port_gcp.INSTANCE_LABEL
    idle_head = {"node_id": head, "state": "ALIVE",
                 "total": _wire({"CPU": 2.0}),
                 "available": _wire({"CPU": 2.0}), "idle": True,
                 "labels": {}}

    def load(nodes, pending=(), pgs=()):
        return {"nodes": [idle_head, *nodes],
                "pending_resources": [_wire(r) for r in pending],
                "pending_total": len(pending),
                "pending_pg_bundles": [{"resources": _wire(b)} for b in pgs],
                "delta": False}

    def row(nid, name, total, idle, state="ALIVE"):
        return {"node_id": nid, "state": state, "total": _wire(total),
                "available": _wire(total if idle else {"CPU": 0.0}),
                "idle": idle, "labels": {label: name}}

    store = {"load": None}
    calls = []

    class Scripted(port_as.Autoscaler):
        def _control_call(self, method, payload, timeout=30.0):
            calls.append((method, payload))
            return store["load"] if method == "get_cluster_load" else {}

    def step(advance=1.0, **kw):
        store["load"] = load(**kw)
        out = scaler.reconcile_once()
        clock["t"] += advance
        return out

    def sent(method):
        return [p["node_id"].hex() for m, p in calls if m == method]

    t = port_gcp.FakeGcpTransport(op_latency=0)
    provider = port_gcp.GpuVmNodeProvider(
        project="p", zone="z", control_address="a:1", transport=t)
    assert isinstance(provider, port_as.NodeProvider)
    scaler = Scripted(provider, port_as.AutoscalingConfig(
        min_workers=0, max_workers=2, worker_resources=worker,
        idle_timeout_s=5.0, poll_period_s=1.0, slice_types={
            "H100-16": port_as.SliceSpec(hosts=2, resources_per_host=host)},
        max_slices=1))

    # a GPU shape launches one worker; until its daemon registers it is a
    # launching bin (the same shape again launches nothing) and alive
    assert step(nodes=[], pending=[{"GPU": 1.0}])["launched"] == 1
    (w,) = scaler.workers
    name = w["name"]
    assert w["node_id"] == name and w["match_labels"] == {label: name}
    assert step(nodes=[], pending=[{"GPU": 1.0}])["launched"] == 0
    assert provider.node_alive(w) and len(scaler.workers) == 1
    # its daemon registers under an id of its own, labelled with the
    # instance name: the handle takes that id and is a launching bin no more
    booted = "0a" * 16
    assert step(nodes=[row(booted, name, worker, idle=False)])[
        "launched"] == 0
    assert w["node_id"] == booted
    assert scaler._unmet_worker_need(load(
        [row(booted, name, worker, idle=False)],
        pending=[{"GPU": 1.0}])) == 1
    # idle past the timeout: drained, then unregistered and deleted
    for _ in range(3):
        step(advance=3.0, nodes=[row(booted, name, worker, idle=True)])
    assert sent("drain_node") == [booted]
    out = step(nodes=[row(booted, name, worker, idle=True,
                          state="DRAINING")])
    assert out["terminated"] == 1 and not scaler.workers
    assert sent("unregister_node") == [booted]
    assert name not in t.instances and not provider.node_alive(w)

    # a worker whose instance is gone before its daemon came is pruned;
    # while the instance lives it is kept however long the boot takes
    assert step(nodes=[], pending=[{"GPU": 1.0}])["launched"] == 1
    (w2,) = scaler.workers
    for _ in range(3):
        step(advance=10.0, nodes=[])
    assert scaler.workers == [w2]
    del t.instances[w2["name"]]
    step(nodes=[])
    assert scaler.workers == []

    # a domain for a pending head token: launching capacity until every
    # host's daemon registers, then an idle domain drains and terminates
    head_token = {"GPU-H100-16-head": 1.0}
    assert step(nodes=[], pgs=[head_token])["launched_slices"] == 1
    (sl,) = scaler.slices
    hosts = [n["name"] for n in sl["nodes"]]
    assert sorted(t.instances) == sorted(hosts)
    assert step(nodes=[], pgs=[head_token])["launched_slices"] == 0
    ids = ["1b" * 16, "1c" * 16]
    rows = [row(i, n, host, idle=True) for i, n in zip(ids, hosts)]
    step(nodes=rows)
    assert [n["node_id"] for n in sl["nodes"]] == ids
    assert scaler._slice_need(load(rows, pgs=[head_token])) == {
        "H100-16": 1}
    for _ in range(3):
        step(advance=3.0, nodes=rows)
    assert sent("drain_node")[-2:] == ids
    out = step(nodes=[dict(r, state="DRAINING") for r in rows])
    assert out["terminated"] == 2 and not scaler.slices
    assert sent("unregister_node")[-2:] == ids
    assert not t.instances and not provider.node_alive(sl)
    # a domain handle is alive while any of its hosts is
    sl2 = provider.create_slice("H100-16", port_as.SliceSpec(
        hosts=2, resources_per_host=host))
    del t.instances[sl2["nodes"][0]["name"]]
    assert provider.node_alive(sl2)
    del t.instances[sl2["nodes"][1]["name"]]
    assert not provider.node_alive(sl2)


# ---------------------------------------------------------------------------
# mid: tests/test_autoscaler_gcp.py's cluster cases on port clusters
# ---------------------------------------------------------------------------


def _daemon_boot(control_address, session_dir):
    """The FakeGcpTransport boot hook: what a GPU VM's startup script does
    — start one node daemon with the metadata's resources, the head token
    on host 0 and the domain labels — returning a cleanup callable."""
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch._private import protocol as pb

    def boot(name, kind, labels, metadata):
        if kind == "gce":
            proc, _ = node_mod.start_node_daemon(
                control_address, session_dir,
                resources=json.loads(metadata["rt-resources"]),
                labels={port_gcp.INSTANCE_LABEL: name})
        else:
            resources = json.loads(metadata["rt-resources"])
            pod_type, h = metadata["rt-pod-type"], metadata["rt-host-index"]
            if h == "0":
                resources[f"GPU-{pod_type}-head"] = 1.0
            proc, _ = node_mod.start_node_daemon(
                control_address, session_dir, resources=resources,
                labels={"gpu-domain-name": metadata["rt-slice-name"],
                        "gpu-pod-type": pod_type,
                        pb.GPU_COORD_LABEL: f"0,{h}",
                        port_gcp.INSTANCE_LABEL: name})
        return lambda: node_mod.kill_process(proc)

    return boot


@pytest.mark.mid
def test_autoscaler_provisions_domain_through_fake_cloud():
    """E2E: a pending domain placement group drives the autoscaler through
    GpuVmNodeProvider -> (fake) GCE API -> booted hosts join -> the PG
    schedules."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.gpu.slice import slice_placement_group
    from ray_tpu_torch.util.state import list_nodes

    info = rt.init(num_cpus=1)
    t = port_gcp.FakeGcpTransport(
        boot=_daemon_boot(info["address"], info["session_dir"]))
    provider = port_gcp.GpuVmNodeProvider(
        project="proj", zone="us-central1-a",
        control_address=info["address"], transport=t, cluster_name="e2e")
    scaler = port_as.Autoscaler(provider, port_as.AutoscalingConfig(
        min_workers=0, max_workers=0, idle_timeout_s=3600,
        poll_period_s=0.3,
        slice_types={"H100-8": port_as.SliceSpec(
            hosts=1, resources_per_host={"CPU": 1.0, "GPU": 8.0})},
        max_slices=1,
    )).start()
    try:
        spg = slice_placement_group(pod_type="H100-8", num_slices=1)
        assert spg.ready(timeout=120), "domain PG never became ready"
        assert len(t.instances) == 1
        (name, inst), = t.instances.items()
        assert inst["labels"]["rt-pod-type"] == "h100-8"
        labeled = [n for n in list_nodes()
                   if n["labels"].get("gpu-pod-type") == "H100-8"]
        assert len(labeled) == 1
        spg.remove()
    finally:
        scaler.stop()
        rt.shutdown()
    assert not t.instances, "teardown must delete the domain's instances"


@pytest.mark.mid
def test_launcher_yaml_up_down(tmp_path):
    """`up` path: YAML -> head + autoscaler -> tasks run -> down."""
    import ray_tpu_torch as rt

    cfg_path = tmp_path / "cluster.yaml"
    cfg_path.write_text(yaml.safe_dump({
        "cluster_name": "yamltest",
        "provider": {"type": "local"},
        "head": {"resources": {"CPU": 2}},
        "workers": {"resources": {"CPU": 2, "GPU": 1}, "min_workers": 0,
                    "max_workers": 1, "idle_timeout_s": 3600},
    }))
    cfg = port_launcher.load_cluster_config(str(cfg_path))
    assert cfg["cluster_name"] == "yamltest"
    cluster = port_launcher.cluster_up(cfg)
    try:
        @rt.remote
        def f(x):
            return x + 1

        assert rt.get(f.remote(41), timeout=60) == 42

        @rt.remote(num_gpus=1)
        def g(x):
            return x * 2

        assert rt.get(g.remote(21), timeout=120) == 42
        assert len(cluster.autoscaler.workers) == 1
    finally:
        cluster.shutdown()
        rt.shutdown()
