"""The port's scale plane and CLI: ``_private/simnode.py`` (the
simulated-node plane), ``cluster_utils.Cluster.add_sim_nodes`` and
``python -m ray_tpu_torch.scripts``. The simnode cases are the
counterparts of the JAX package's ``test_scale_plane.py`` cases on the
plane (its in-stream gap reconcile, real placement skipping simnodes, a
plane's convergence, drain and leases, ``add_sim_nodes`` of 8 nodes); the
CLI cases drive ``start``, ``status``, ``serve deploy``, ``serve status``,
``job submit``, ``job status``, ``job logs``, ``job stop``, ``job list``
and ``stop`` in subprocesses, then ``up`` of a YAML whose GPU worker the
autoscaler starts for a GPU task, and ``down``. Nothing here imports
torch.
"""

import asyncio
import json
import os
import subprocess
import sys
import time

import pytest

from ray_tpu_torch._private import protocol as pb
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.protocol import NodeInfo, ResourceSet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _node_wire(node_id=None, address="127.0.0.1:1"):
    return NodeInfo(
        node_id=node_id or NodeID.from_random(),
        address=address,
        object_store_name="none",
        resources=ResourceSet({"CPU": 2}),
    ).to_wire()


# ---------------------------------------------------------------------------
# versioned node-table delta sync
# ---------------------------------------------------------------------------


def test_simnode_in_stream_gap_triggers_cursor_reconcile():
    """A seq jump INSIDE the stream (the shed-backlog signature) triggers
    a reconcile from the PRE-gap cursor that replays exactly the missed
    mutations. The critical shape: the subscriber SAW a node register,
    then missed its DEATH in the shed window — the gap-revealing notice's
    `_v` advances the cursor past the window before the (deferred)
    reconcile task runs, so a reconcile reading the live cursor would
    replay nothing and the dead node would stay a member forever."""
    from ray_tpu_torch._private.control_store import ControlStore
    from ray_tpu_torch._private.simnode import SimNode

    async def run():
        cs = ControlStore()
        addr = await cs.start(port=0)
        try:
            sim = SimNode(addr, index=0, seed=7, serve=False,
                          heartbeat=False)
            await sim.start()
            # the subscriber SEES `gone` register through the stream
            gone = _node_wire()
            await cs.rpc_register_node(0, {"node": gone})
            gone_hex = NodeID(gone["node_id"]).hex()
            for _ in range(40):
                if gone_hex in sim.membership:
                    break
                await asyncio.sleep(0.05)
            assert gone_hex in sim.membership

            # ... then its DEATH is shed: mutate without this subscriber
            cs.pubsub.unsubscribe_conn(
                next(iter(cs.pubsub._subs.get("nodes", {1}))))
            await cs.rpc_unregister_node(
                0, {"node_id": gone["node_id"], "expected": False,
                    "reason": "x"})
            # hand the subscriber the NEXT notice with the jumped seq and
            # the store's CURRENT version (what a real successor carries)
            seq = cs.pubsub.channel_seq("nodes") + 1
            cs.pubsub.seq["nodes"] = seq
            sim._on_nodes_message({**_node_wire(), "_seq": seq,
                                   "_v": cs._node_version})
            for _ in range(40):
                if (sim.gaps_reconciled
                        and (sim._reconcile_task is None
                             or sim._reconcile_task.done())):
                    break
                await asyncio.sleep(0.05)
            assert sim.gaps_reconciled == 1
            # the reconcile replayed the missed death from the pre-gap
            # cursor: `gone` is no longer a member
            assert gone_hex not in sim.membership
            await sim.stop()
        finally:
            await cs.stop()

    asyncio.run(run())


# ---------------------------------------------------------------------------
# simnodes are control-plane-only: real placement must exclude them
# ---------------------------------------------------------------------------


def test_real_placement_excludes_simnodes():
    """Actor scheduling and PG bin-pack skip nodes labeled simnode=true
    even when the simnode has MORE free capacity — scripted lease grants
    must never receive real work (found by an E2E drive: a real task
    lease spilled to a simnode and got a fake worker address)."""
    from ray_tpu_torch._private.control_store import ControlStore
    from ray_tpu_torch._private.ids import JobID, TaskID
    from ray_tpu_torch._private.protocol import Bundle, TaskSpec

    async def run():
        cs = ControlStore()
        real = NodeInfo(
            node_id=NodeID.from_random(), address="127.0.0.1:1",
            object_store_name="none", resources=ResourceSet({"CPU": 2}),
        )
        sim = NodeInfo(
            node_id=NodeID.from_random(), address="simnode-x:0",
            object_store_name="none", resources=ResourceSet({"CPU": 64}),
            labels={"simnode": "true"},
        )
        for info in (real, sim):
            await cs.rpc_register_node(0, {"node": info.to_wire()})

        spec = TaskSpec(task_id=TaskID.from_random(),
                        job_id=JobID.from_random(),
                        resources=ResourceSet({"CPU": 1}))
        for _ in range(8):  # pack would prefer the fatter simnode
            assert cs._pick_node_for(spec, set()) == real.node_id.binary()

        from ray_tpu_torch._private.control_store import PlacementGroupRecord

        from ray_tpu_torch._private.ids import PlacementGroupID

        rec = PlacementGroupRecord(
            pg_id=PlacementGroupID.from_random(),
            bundles=[Bundle(index=0, resources=ResourceSet({"CPU": 1}))],
            strategy=pb.PG_PACK, name="",
        )
        placements = cs._place_bundles(rec)
        assert placements == {0: real.node_id.binary()}

    asyncio.run(run())


# ---------------------------------------------------------------------------
# the simnode plane end to end (+ cluster_utils integration)
# ---------------------------------------------------------------------------


def test_simnode_plane_converges_drains_and_leases():
    """A small plane against an in-process store: register storm, full
    membership convergence, scripted lease grant + spillback replies, a
    drain wave, zero protocol errors."""
    from ray_tpu_torch._private.control_store import ControlStore
    from ray_tpu_torch._private.simnode import SimNodePlane
    from ray_tpu_torch.runtime.rpc import RpcClient

    async def run():
        GLOBAL_CONFIG.apply_system_config({
            "pubsub_flush_window_ms": 5.0,
            "node_table_delta_sync": True,
        })
        cs = ControlStore()
        addr = await cs.start(port=0)
        try:
            plane = SimNodePlane(addr, 20, seed=5)
            await plane.start()
            await plane.await_converged(timeout=30)

            # scripted lease protocol: hot entry grants once, then spills
            # with the real reply shape
            first = plane.nodes[0]
            client = RpcClient(first.address, name="test->sim")
            await client.connect()
            res = ResourceSet({"CPU": 4.0}).to_wire()
            r1 = await client.call("request_lease", {
                "resources": res, "job_id": b"", "hops": 0})
            assert r1["granted"] and r1["node_id"] == first.node_id.hex()
            r2 = await client.call("request_lease", {
                "resources": res, "job_id": b"", "hops": 0})
            assert "spillback" in r2 and r2["spillback"] != first.address
            await client.call("return_lease", {"lease_id": r1["lease_id"]})
            assert first.available.to_dict() == {"CPU": 4.0}
            await client.close()

            await plane.drain_wave(5, deadline_s=0.2)
            await plane.await_converged(timeout=30)
            stats = plane.stats()
            assert stats["alive"] == 15
            assert stats["protocol_errors"] == []
            # membership views agree everywhere
            views = {frozenset(n.membership) for n in plane.alive()}
            assert len(views) == 1
            await plane.stop()
        finally:
            await cs.stop()

    asyncio.run(run())


def test_cluster_utils_add_sim_nodes():
    """Cluster.add_sim_nodes attaches a subprocess simnode plane next to
    the real head daemon; the control store sees all of them."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.runtime.rpc import RpcClient

    cluster = Cluster(initialize_head=True)
    try:
        handle = cluster.add_sim_nodes(8, seed=3)
        assert handle.count == 8 and len(handle.node_ids) == 8

        async def check():
            client = RpcClient(cluster.address, name="test->cs")
            await client.connect()
            deadline = time.monotonic() + 30
            while True:
                reply = await client.call("get_all_nodes", {})
                alive = [n for n in reply["nodes"]
                         if n["state"] == pb.NODE_ALIVE]
                if len(alive) == 9:  # 1 real head + 8 simulated
                    break
                assert time.monotonic() < deadline, len(alive)
                await asyncio.sleep(0.2)
            # pagination on the store read too
            page = await client.call("get_all_nodes",
                                     {"offset": 0, "limit": 4})
            assert page["total"] == 9 and len(page["nodes"]) == 4
            await client.close()

        asyncio.run(check())
    finally:
        cluster.shutdown()


# ---------------------------------------------------------------------------
# the CLI: python -m ray_tpu_torch.scripts
# ---------------------------------------------------------------------------


def _cli(env, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A head node started by the CLI. The CLI keeps its state file in the
    temp dir, so TMPDIR isolates this cluster's from any other; the serve
    app's module sits on the PYTHONPATH the head's processes inherit."""
    tmp = tmp_path_factory.mktemp("cli")
    (tmp / "cli_app_torch.py").write_text(
        "from ray_tpu_torch import serve\n"
        "\n"
        "@serve.deployment(num_replicas=1)\n"
        "class Echo:\n"
        "    def __call__(self, x):\n"
        "        return {'echo': x}\n"
        "\n"
        "app = Echo.bind()\n")
    env = dict(os.environ, TMPDIR=str(tmp),
               PYTHONPATH=os.pathsep.join([ROOT, str(tmp)]))
    out = _cli(env, "start", "--head", "--num-cpus", "4", "--num-gpus", "2")
    started = {"out": out, "env": env, "tmp": tmp}
    yield started
    _cli(env, "stop", timeout=60)


def test_cli_start_writes_its_state(cli):
    out = cli["out"]
    assert out.returncode == 0, out.stderr
    assert "ray_tpu_torch head started" in out.stdout
    address = [ln for ln in out.stdout.splitlines()
               if "address:" in ln][0].split()[-1]
    with open(cli["tmp"] / "ray_tpu_sessions"
              / "torch_cluster_state.json") as f:
        state = json.load(f)
    assert state["address"] == address
    assert len(state["nodes"]) == 1 and state["nodes"][0]["head"]


def test_cli_status_shows_the_gpus(cli):
    st = _cli(cli["env"], "status")
    assert st.returncode == 0, st.stderr
    assert "1 node(s)" in st.stdout
    assert "'GPU': 2.0" in st.stdout and "'CPU': 4.0" in st.stdout


def test_cli_serve_deploy_then_status(cli):
    import urllib.request

    cfg = cli["tmp"] / "serve.json"
    cfg.write_text(json.dumps({
        "applications": [{"import_path": "cli_app_torch:app"}],
        "http": {"port": 0}}))
    dep = _cli(cli["env"], "serve", "deploy", str(cfg))
    assert dep.returncode == 0, dep.stderr
    got = json.loads(dep.stdout.strip().splitlines()[-1])
    assert got["applications"] == ["Echo"] and got["http"].startswith(
        "http://")
    req = urllib.request.Request(
        f"{got['http']}/Echo", data=json.dumps(7).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert json.loads(r.read())["result"] == {"echo": 7}
    st = _cli(cli["env"], "serve", "status")
    assert st.returncode == 0, st.stderr
    assert json.loads(st.stdout)["Echo"]["running"] == 1


def test_cli_job_submit_waits_for_the_logs(cli):
    out = _cli(cli["env"], "job", "submit", "--", sys.executable, "-c",
               "print('cli-job-ok')", timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "cli-job-ok" in out.stdout
    sid = out.stdout.split("submitted job ")[1].split()[0]
    assert f"job {sid} finished: SUCCEEDED" in out.stdout
    st = _cli(cli["env"], "job", "status", sid)
    assert st.returncode == 0 and st.stdout.strip() == "SUCCEEDED", st.stderr
    logs = _cli(cli["env"], "job", "logs", sid)
    assert logs.returncode == 0 and "cli-job-ok" in logs.stdout


def test_cli_job_stop_of_a_gpu_job(cli):
    """A job leasing one of the head's two GPUs, submitted without waiting,
    then stopped: `status` reads RUNNING, then STOPPED, and `list` shows
    it."""
    out = _cli(cli["env"], "job", "submit", "--no-wait", "--resources",
               json.dumps({"GPU": 1}), "--", sys.executable, "-c",
               "import time; time.sleep(600)")
    assert out.returncode == 0, out.stderr
    sid = out.stdout.split("submitted job ")[1].split()[0]
    deadline = time.time() + 60
    status = ""
    while time.time() < deadline and status != "RUNNING":
        status = _cli(cli["env"], "job", "status", sid).stdout.strip()
        time.sleep(0.3)
    assert status == "RUNNING"
    stop = _cli(cli["env"], "job", "stop", sid)
    assert stop.returncode == 0 and f"stopped {sid}" in stop.stdout
    st = _cli(cli["env"], "job", "status", sid)
    assert st.stdout.strip() == "STOPPED", st.stdout + st.stderr
    listed = _cli(cli["env"], "job", "list")
    assert any(ln.startswith(sid) and "STOPPED" in ln
               for ln in listed.stdout.splitlines()), listed.stdout


def test_cli_stop_ends_the_cluster(cli):
    out = _cli(cli["env"], "stop", timeout=60)
    assert out.returncode == 0, out.stderr
    assert "stopped 2 processes" in out.stdout
    assert not (cli["tmp"] / "ray_tpu_sessions"
                / "torch_cluster_state.json").exists()
    st = _cli(cli["env"], "status")
    assert st.returncode == 2 and "no running cluster" in st.stderr


_UP_DRIVER = """
import json, os, sys
import ray_tpu_torch as rt

rt.init(address=sys.argv[1])

@rt.remote(num_gpus=1)
def where():
    return os.environ["RT_NODE_ID"]

node = rt.get(where.remote(), timeout=120)
print(json.dumps({"node": node, "nodes": rt.nodes()}))
rt.shutdown()
"""


def _session_pids(session_dir):
    """Pids whose command line or environment names ``session_dir``."""
    key = session_dir.encode()
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{d}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        if cmd and (key in cmd or key in env):
            pids.append(int(d))
    return pids


def test_cli_up_down(tmp_path):
    """`up` a YAML with the local provider and a GPU worker type: a
    num_gpus=1 task on the head (which has no GPU) makes the autoscaler
    start a worker, where it runs; `down` ends the `up` process, which
    tears down the head and the worker: no process of the cluster left."""
    import yaml

    cfg = tmp_path / "cluster.yaml"
    cfg.write_text(yaml.safe_dump({
        "cluster_name": "cli-up",
        "provider": {"type": "local"},
        "head": {"resources": {"CPU": 2}},
        "workers": {"resources": {"CPU": 1, "GPU": 1}, "min_workers": 0,
                    "max_workers": 1, "idle_timeout_s": 60},
    }))
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=ROOT)
    state_file = tmp_path / "ray_tpu_sessions" / "torch_cluster_state.json"
    up = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "up", str(cfg)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    session = None
    try:
        deadline = time.monotonic() + 60
        while not state_file.exists():
            assert up.poll() is None, up.stdout.read()
            assert time.monotonic() < deadline, "up never wrote its state"
            time.sleep(0.2)
        state = json.loads(state_file.read_text())
        (entry,) = state["nodes"]
        assert entry["up_pid"] == up.pid and entry["head"]
        session = entry["session_dir"]
        out = subprocess.run(
            [sys.executable, "-c", _UP_DRIVER, state["address"]],
            capture_output=True, text=True, timeout=180, env=env, cwd=ROOT)
        assert out.returncode == 0, out.stdout + out.stderr
        got = json.loads(out.stdout.strip().splitlines()[-1])
        by_id = {n["node_id"]: n for n in got["nodes"]}
        assert len(by_id) == 2, got["nodes"]
        assert by_id[got["node"]]["resources"].get("GPU") == 1.0
        assert all("GPU" not in n["resources"] for i, n in by_id.items()
                   if i != got["node"])
        down = _cli(env, "down", timeout=60)
        assert down.returncode == 0, down.stderr
        assert f"signalled `up` process {up.pid}" in down.stdout
        assert up.wait(timeout=60) == 0
        assert "shutting down cluster" in up.stdout.read()
        assert not state_file.exists()
        deadline = time.monotonic() + 30
        while _session_pids(session) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert _session_pids(session) == []
    finally:
        if up.poll() is None:
            up.kill()
            up.wait()
        for pid in _session_pids(session) if session else ():
            try:
                os.kill(pid, 9)
            except OSError:
                pass
