"""The port's job plane (``ray_tpu_torch/job_submission``) against the 11
cases of the JAX package's ``test_jobs.py``: the lifecycle, tenancy and
quotas, the fair-share queue, adoption after a manager restart, the job
table across a control-store failover, the supervisor-death cases, and a
node killed under a job on an autoscaled fleet (the port's autoscaler).
The runtime imports no torch, so these run in the pytest worker.
"""

import asyncio
import os
import signal
import sys
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import node as node_mod
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.job_submission import (
    FAILED,
    PENDING,
    QUEUED,
    RUNNING,
    STOPPED,
    SUCCEEDED,
    JOBS_NAMESPACE,
    FairShareQueue,
    JobSubmissionClient,
)
from ray_tpu_torch.runtime.rpc import RpcClient
from ray_tpu_torch.util.metrics import reset_registry

TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The conftest fixture resets the JAX package's registries; this one
    resets the port's (the module's cluster keeps the config it started
    with: its processes hold their own copies)."""
    yield
    GLOBAL_CONFIG.reset()
    chaos.reset()
    reset_registry()


@pytest.fixture(scope="module")
def cluster():
    info = rt.init(num_cpus=8, system_config={
        "health_check_timeout_s": 2.0,
        "job_poll_period_s": 0.3,
    })
    yield info
    rt.shutdown()


@pytest.fixture()
def client(cluster):
    return JobSubmissionClient()


# ---------------------------------------------------------------------------
# test_jobs.py
# ---------------------------------------------------------------------------


def _wait_status(client, sid, want, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = client.get_job_status(sid)
        if st in want:
            return st
        if st in TERMINAL:  # terminal but not wanted: stop waiting
            return st
        time.sleep(0.2)
    raise TimeoutError(f"job {sid} still {st}, wanted {want}")


def _quick(msg="ok"):
    return f"{sys.executable} -c \"print('{msg}')\""


def _sleep(sec):
    return f"{sys.executable} -c \"import time; time.sleep({sec})\""


# ---------------------------------------------------------------------------
# lifecycle + tenancy
# ---------------------------------------------------------------------------


def test_lifecycle_records_tenant_and_times(client):
    sid = client.submit_job(entrypoint=_quick("tenant-job"),
                            tenant="alice", resources={"CPU": 1.0})
    assert _wait_status(client, sid, (SUCCEEDED,)) == SUCCEEDED
    info = client.get_job_info(sid)
    assert info["tenant"] == "alice"
    assert info["resources"] == {"CPU": 1.0}
    assert info["submit_time"] <= info["start_time"] <= info["end_time"]
    assert info["driver_pid"] > 0
    assert "tenant-job" in client.get_job_logs(sid)
    listed = client.list_jobs(tenant="alice")
    assert sid in {j["submission_id"] for j in listed}
    # tenant filter excludes it under another key
    assert sid not in {j["submission_id"]
                       for j in client.list_jobs(tenant="bob")}


def test_quota_caps_concurrent_jobs(client):
    client.set_tenant("quota-t", max_running=1)
    sids = [client.submit_job(entrypoint=_sleep(1.5), tenant="quota-t")
            for _ in range(3)]
    deadline = time.time() + 90
    max_admitted = 0
    while time.time() < deadline:
        statuses = [client.get_job_status(s) for s in sids]
        admitted = sum(1 for s in statuses if s in (PENDING, RUNNING))
        max_admitted = max(max_admitted, admitted)
        assert admitted <= 1, f"quota breached: {statuses}"
        if all(s in TERMINAL for s in statuses):
            break
        time.sleep(0.1)
    assert [client.get_job_status(s) for s in sids] == [SUCCEEDED] * 3
    assert max_admitted == 1  # the quota was actually exercised


# ---------------------------------------------------------------------------
# fair share: deterministic proof + e2e burst
# ---------------------------------------------------------------------------


def test_fair_share_equal_weights_bounded_error():
    """3 tenants, one submitting 10x: while every tenant stays backlogged,
    admitted-work share must stay within one job of exact equality — the
    flood tenant cannot starve the others (counter-asserted)."""
    weights = {"flood": 1.0, "a": 1.0, "b": 1.0}
    q = FairShareQueue(lambda t: weights[t])
    for i in range(100):
        q.push("flood", f"f{i}", 1.0)
    for i in range(10):
        q.push("a", f"a{i}", 1.0)
        q.push("b", f"b{i}", 1.0)
    admitted = {"flood": 0, "a": 0, "b": 0}
    # all three tenants backlogged for the first 30 admissions
    for n in range(1, 31):
        tenant, _ = q.pop(lambda t, i: True)
        admitted[tenant] += 1
        for share in (admitted[t] / n for t in weights):
            assert abs(share - 1 / 3) <= 1.0 / n + 1e-9
    assert admitted == {"flood": 10, "a": 10, "b": 10}
    # the flood tenant drains alone once the others are empty
    rest = [q.pop(lambda t, i: True)[0] for _ in range(90)]
    assert set(rest) == {"flood"}
    assert q.pop(lambda t, i: True) is None


def test_fair_share_weighted_shares_converge():
    """Completed-work share converges to the weight ratio (1:3) within a
    one-admission error bound while both tenants stay backlogged."""
    weights = {"small": 1.0, "big": 3.0}
    q = FairShareQueue(lambda t: weights[t])
    for i in range(40):
        q.push("small", f"s{i}", 1.0)
        q.push("big", f"b{i}", 1.0)
    admitted = {"small": 0, "big": 0}
    for n in range(1, 41):
        tenant, _ = q.pop(lambda t, i: True)
        admitted[tenant] += 1
        assert abs(admitted["big"] / n - 0.75) <= 1.0 / n + 1e-9
    assert admitted == {"small": 10, "big": 30}


def test_fair_share_idle_tenant_banks_no_credit():
    """A tenant idle through 50 admissions must not monopolize admission
    when it returns — its vtime rejoins at the active floor."""
    q = FairShareQueue(lambda t: 1.0)
    for i in range(60):
        q.push("busy", f"x{i}", 1.0)
    for _ in range(50):
        q.pop(lambda t, i: True)
    q.push("returning", "r0", 1.0)
    q.push("returning", "r1", 1.0)
    q.push("returning", "r2", 1.0)
    picks = [q.pop(lambda t, i: True)[0] for _ in range(6)]
    # strict alternation from the shared floor, not a "returning" burst
    assert picks == ["busy", "returning"] * 3


def test_fair_share_burst_e2e(client):
    """The cluster-level burst: three serial-quota tenants, one submitting
    10x — the small tenants' jobs must all start within the first few
    admissions instead of queueing behind the flood."""
    for t in ("ft", "t1", "t2"):
        client.set_tenant(t, max_running=1, weight=1.0)
    flood = [client.submit_job(entrypoint=_quick(f"flood{i}"), tenant="ft")
             for i in range(10)]
    small = [client.submit_job(entrypoint=_quick(f"small{i}"), tenant=t)
             for t in ("t1", "t2") for i in range(2)]
    for sid in small + flood:
        assert _wait_status(client, sid, (SUCCEEDED,), 180) == SUCCEEDED
    started = sorted(
        (client.get_job_info(s)["start_time"], s) for s in flood + small)
    order = [sid for _, sid in started]
    # the flood cannot starve the small tenants: by the time the last
    # small job starts, only a handful of flood jobs may have started
    late_small = max(order.index(s) for s in small)
    flood_before_small = sum(1 for sid in order[:late_small] if sid in flood)
    assert flood_before_small <= 5, (
        f"{flood_before_small} flood jobs started before the small tenants "
        f"finished starting — fair share failed (order={order})")
    stats = client.fair_share_stats()
    assert stats["t1"]["completed_cost"] == pytest.approx(2.0)
    assert stats["t2"]["completed_cost"] == pytest.approx(2.0)
    assert stats["ft"]["completed_cost"] == pytest.approx(10.0)


# ---------------------------------------------------------------------------
# durability: manager restart + store failover
# ---------------------------------------------------------------------------


def test_manager_restart_adopts_running_job(client):
    sid = client.submit_job(entrypoint=_sleep(5), tenant="surv")
    assert _wait_status(client, sid, (RUNNING,)) == RUNNING
    rt.kill(client._manager)
    time.sleep(0.5)
    fresh = JobSubmissionClient()
    # the new manager recovered the table and re-adopted the supervisor:
    # the job keeps running and lands SUCCEEDED, not FAILED/lost
    assert fresh.get_job_status(sid) == RUNNING
    assert _wait_status(fresh, sid, (SUCCEEDED,), 120) == SUCCEEDED


def _failover_cfg():
    GLOBAL_CONFIG.apply_system_config({
        "control_store_persist": True,
        "store_standby_enabled": True,
        "store_failover_timeout_s": 10.0,
        "store_fence_epoch_renew_s": 0.25,
        "node_table_delta_sync": True,
    })


def test_job_table_survives_store_failover():
    """THE durability claim: kill -9 the control store mid-flight; the
    warm standby takes over at the same address with every submitted job
    intact — none lost, terminal guard still enforced, tenant config
    (KV) preserved."""
    _failover_cfg()
    try:
        session = node_mod.new_session_dir()
        cs_proc, addr = node_mod.start_control_store(session)
        standby = node_mod.start_standby_store(session, addr)

        async def phase1():
            c = RpcClient(addr, name="jobs-pub")
            await c.connect()
            for i in range(12):
                rec = {"submission_id": f"job-{i:03d}",
                       "entrypoint": f"echo {i}",
                       "tenant": f"t{i % 3}", "status": QUEUED,
                       "resources": {"CPU": 1.0}, "submit_time": 1000.0 + i}
                assert (await c.call("job_put", {"job": rec}))["ok"]
            await c.call("job_update", {
                "submission_id": "job-000",
                "fields": {"status": RUNNING, "driver_pid": 4242}})
            await c.call("job_update", {
                "submission_id": "job-001",
                "fields": {"status": SUCCEEDED}})
            await c.call("kv_put", {"ns": "_job_plane", "key": b"tenants",
                                    "value": b'{"t0": {"weight": 5.0}}'})
            await c.close()

        asyncio.run(phase1())
        node_mod.kill_process(cs_proc, force=True)
        node_mod._wait_ready(standby.standby_ready_file, standby, 60.0)

        async def phase2():
            c = RpcClient(addr, name="jobs-check")
            await c.connect()
            reply = await c.call("job_list", {"offset": 0, "limit": 100})
            assert reply["total"] == 12, reply
            by_id = {j["submission_id"]: j for j in reply["jobs"]}
            assert by_id["job-000"]["status"] == RUNNING
            assert by_id["job-000"]["driver_pid"] == 4242
            assert by_id["job-001"]["status"] == SUCCEEDED
            assert by_id["job-005"]["tenant"] == "t2"
            # terminal guard survives takeover: SUCCEEDED never transitions
            bad = await c.call("job_put", {"job": {
                "submission_id": "job-001", "status": RUNNING}})
            assert not bad["ok"] and bad.get("terminal")
            kv = await c.call("kv_get", {"ns": "_job_plane",
                                         "key": b"tenants"})
            assert b"5.0" in bytes(kv["value"])
            # pagination works on the new incumbent
            page = await c.call("job_list", {"offset": 10, "limit": 5})
            assert page["total"] == 12 and len(page["jobs"]) == 2
            await c.close()

        asyncio.run(phase2())
    finally:
        for proc in (cs_proc, standby):
            node_mod.kill_process(proc, force=True)
        GLOBAL_CONFIG.reset()


# ---------------------------------------------------------------------------
# chaos: supervisor death, fate-sharing, node kill + autoscaler convergence
# ---------------------------------------------------------------------------


def _supervisor_handle(sid):
    return rt.get_actor(f"job-supervisor:{sid}",
                             namespace=JOBS_NAMESPACE)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def test_supervisor_death_fails_job_and_releases_quota(client):
    client.set_tenant("mort", max_running=2)
    sid = client.submit_job(entrypoint=_sleep(120), tenant="mort")
    assert _wait_status(client, sid, (RUNNING,)) == RUNNING
    sup = _supervisor_handle(sid)
    spid = rt.get(sup.pid.remote(), timeout=30)
    cpid = rt.get(sup.child_pid.remote(), timeout=30)
    assert _pid_alive(cpid)
    os.kill(spid, signal.SIGKILL)
    assert _wait_status(client, sid, (FAILED,), 60) == FAILED
    assert "supervisor" in client.get_job_info(sid)["message"]
    # supervisor->driver fate-share: the child dies with its supervisor
    deadline = time.time() + 10
    while time.time() < deadline and _pid_alive(cpid):
        time.sleep(0.2)
    assert not _pid_alive(cpid), "orphaned driver survived supervisor death"
    stats = client.fair_share_stats()
    assert stats["mort"]["running"] == 0, stats  # quota released


def test_supervisor_death_resubmits_under_max_retries(client):
    sid = client.submit_job(entrypoint=_sleep(3), tenant="retry",
                            max_retries=1)
    assert _wait_status(client, sid, (RUNNING,)) == RUNNING
    spid = rt.get(_supervisor_handle(sid).pid.remote(), timeout=30)
    os.kill(spid, signal.SIGKILL)
    # requeued (attempt 2), re-admitted, and completes
    assert _wait_status(client, sid, (SUCCEEDED,), 120) == SUCCEEDED
    info = client.get_job_info(sid)
    assert info["retries_used"] == 1
    assert info["max_retries"] == 1


def test_node_kill_mid_fleet_autoscaler_converges(client, cluster):
    """The job's supervisor is pinned (custom resource) to an
    autoscaler-launched node; kill -9 that node mid-run. The job must land
    FAILED with a surfaced cause, the tenant's quota must free, and the
    autoscaler must converge back to zero workers."""
    from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalingConfig,
                                          LocalNodeProvider)

    provider = LocalNodeProvider(cluster["address"], cluster["session_dir"])
    scaler = Autoscaler(provider, AutoscalingConfig(
        min_workers=0, max_workers=1,
        worker_resources={"CPU": 2.0, "jobnode": 4.0},
        idle_timeout_s=2.0, poll_period_s=0.3,
    )).start()
    try:
        client.set_tenant("chaos", max_running=4)
        sid = client.submit_job(
            entrypoint=_sleep(300), tenant="chaos",
            resources={"CPU": 1.0, "jobnode": 1.0})
        # supervisor infeasible on the head -> autoscaler provisions the
        # jobnode worker -> the job starts there
        assert _wait_status(client, sid, (RUNNING,), 120) == RUNNING
        assert len(scaler.workers) == 1
        victim = scaler.workers[0]
        node_mod.kill_process(victim["proc"], force=True)
        assert _wait_status(client, sid, (FAILED,), 90) == FAILED
        assert client.fair_share_stats()["chaos"]["running"] == 0
        # convergence back down: dead worker pruned, nothing relaunched
        deadline = time.time() + 60
        while time.time() < deadline and scaler.workers:
            time.sleep(0.5)
        assert scaler.workers == [], "autoscaler never converged down"
        alive = [n for n in rt.nodes() if n["state"] == "ALIVE"]
        assert len(alive) == 1  # only the head remains
    finally:
        scaler.stop()
