"""The port's job submission (``ray_tpu_torch/job_submission`` and
``scripts.py job``) against the JAX package's ``test_job_submission.py``
(6): a job's lifecycle, its failure, env vars and working dir, stop, a
driver that joins the cluster, and the CLI. Beside them, a job with
``resources={"GPU": 1}`` leases the (fake) GPU of the cluster while it
runs and gives it back when it is stopped. ``test_torch_jobs.py`` holds
``test_jobs.py``'s cases. The runtime imports no torch, so these run in
the pytest worker.
"""

import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.job_submission import (
    FAILED,
    RUNNING,
    STOPPED,
    SUCCEEDED,
    JobSubmissionClient,
)
from ray_tpu_torch.util.metrics import reset_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    # one fake GPU for the GPU job's lease
    info = rt.init(num_cpus=8, resources={"GPU": 1}, system_config={
        "health_check_timeout_s": 2.0,
        "job_poll_period_s": 0.3,
    })
    yield info
    rt.shutdown()


@pytest.fixture()
def client(cluster):
    return JobSubmissionClient()


# ---------------------------------------------------------------------------
# test_job_submission.py
# ---------------------------------------------------------------------------


def _wait_terminal(client, sid, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = client.get_job_status(sid)
        if st in (SUCCEEDED, FAILED, STOPPED):
            return st
        time.sleep(0.3)
    raise TimeoutError(f"job {sid} still {st}")


def test_submit_and_succeed(client):
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('hello from job')\"")
    assert _wait_terminal(client, sid) == SUCCEEDED
    assert "hello from job" in client.get_job_logs(sid)
    jobs = {j["submission_id"]: j for j in client.list_jobs()}
    assert jobs[sid]["status"] == SUCCEEDED


def test_job_failure_reported(client):
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import sys; sys.exit(3)\"")
    assert _wait_terminal(client, sid) == FAILED
    assert "exit code 3" in client.get_job_info(sid)["message"]


def test_env_vars_and_working_dir(client, tmp_path):
    (tmp_path / "main.py").write_text(
        "import os\nprint('VAL=' + os.environ['JOB_TEST_VAR'])\n"
        "print(open('data.txt').read())\n"
    )
    (tmp_path / "data.txt").write_text("shipped-file")
    sid = client.submit_job(
        entrypoint=f"{sys.executable} main.py",
        runtime_env={
            "working_dir": str(tmp_path),
            "env_vars": {"JOB_TEST_VAR": "42"},
        },
    )
    assert _wait_terminal(client, sid) == SUCCEEDED
    logs = client.get_job_logs(sid)
    assert "VAL=42" in logs
    assert "shipped-file" in logs


def test_stop_running_job(client):
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time; time.sleep(600)\"")
    time.sleep(1)
    assert client.get_job_status(sid) == "RUNNING"
    client.stop_job(sid)
    assert _wait_terminal(client, sid) == STOPPED


def test_job_driver_joins_cluster(client, cluster):
    """A submitted driver can rt.init(address=RT_ADDRESS) and use the
    SAME cluster (reference: job drivers join via RAY_ADDRESS)."""
    script = (
        "import os, ray_tpu_torch\n"
        "ray_tpu_torch.init(address=os.environ['RT_ADDRESS'])\n"
        "@ray_tpu_torch.remote\n"
        "def f():\n"
        "    return 'from-inner-task'\n"
        "print(ray_tpu_torch.get(f.remote(), timeout=60))\n"
        "ray_tpu_torch.shutdown()\n"
    )
    sid = client.submit_job(entrypoint=f"{sys.executable} -c \"{script}\"")
    st = _wait_terminal(client, sid, timeout=120)
    logs = client.get_job_logs(sid)
    assert st == SUCCEEDED, logs
    assert "from-inner-task" in logs


def test_cli_start_status_job_stop(tmp_path):
    """Full CLI lifecycle in subprocesses: start --head, status, job submit,
    stop (reference: `ray start/stop` smoke tests)."""
    # the CLI keeps its state file in the temp dir: TMPDIR isolates this
    # head from any other test's
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=ROOT)
    try:
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", "start", "--head",
             "--num-cpus", "4"],
            capture_output=True, text=True, timeout=120, env=env,
        )
        assert out.returncode == 0, out.stderr
        address = [ln for ln in out.stdout.splitlines()
                   if "address:" in ln][0].split()[-1]
        st = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", "status",
             "--address", address],
            capture_output=True, text=True, timeout=120, env=env,
        )
        assert st.returncode == 0, st.stderr
        assert "1 node(s)" in st.stdout
        job = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", "job",
             "--address", address, "submit", "--",
             sys.executable, "-c", "print('cli-job-ok')"],
            capture_output=True, text=True, timeout=180, env=env,
        )
        assert job.returncode == 0, job.stdout + job.stderr
        assert "cli-job-ok" in job.stdout
    finally:
        subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", "stop"],
            capture_output=True, text=True, timeout=60, env=env,
        )


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


def _sleep(sec):
    return f"{sys.executable} -c \"import time; time.sleep({sec})\""


# ---------------------------------------------------------------------------
# a GPU job
# ---------------------------------------------------------------------------


def _gpu_available():
    return rt.available_resources().get("GPU", 0.0)


def test_gpu_job_leases_the_gpu_and_stop_returns_it(client):
    """resources={"GPU": 1} becomes the supervisor's num_gpus: the GPU is
    leased while the job runs, and stop_job gives it back."""
    before = _gpu_available()
    assert before == 1.0
    sid = client.submit_job(entrypoint=_sleep(600), resources={"GPU": 1})
    assert _wait_status(client, sid, (RUNNING,)) == RUNNING
    deadline = time.time() + 30
    while _gpu_available() != 0.0 and time.time() < deadline:
        time.sleep(0.1)
    assert _gpu_available() == 0.0
    assert client.get_job_info(sid)["resources"] == {"GPU": 1}
    assert client.stop_job(sid)
    assert _wait_status(client, sid, (STOPPED,)) == STOPPED
    deadline = time.time() + 30
    while _gpu_available() != before and time.time() < deadline:
        time.sleep(0.1)
    assert _gpu_available() == before
