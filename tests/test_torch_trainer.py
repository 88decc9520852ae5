"""The port's train library (``ray_tpu_torch.train``: ``TorchTrainer``,
``DataParallelTrainer``, the controller, the worker group, checkpoints)
against the cases of ``test_train.py`` that run, on a cluster of the port.
Its controller and worker group import no torch, so these run in the
pytest worker; the train fns import torch in the port's worker processes.
Added: ``setup_torch_distributed`` at world 2 over gloo (what JAX's skipped
``test_jax_distributed_two_process_mesh`` means), GPU leases of a
``use_gpu`` run, and which configs reserve an NVLink domain (gang placement
itself runs in ``test_torch_slice.py``)."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.train import (
    CheckpointConfig,
    CheckpointManager,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    TrainingFailedError,
)
from ray_tpu_torch.util.metrics import reset_registry


@pytest.fixture(scope="module")
def ray_init():
    # two fake devices: the use_gpu case leases one to each worker
    info = rt.init(num_cpus=8, resources={"GPU": 2})
    yield info
    rt.shutdown()


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The conftest fixture resets the JAX package's registries; this one
    resets the port's."""
    yield
    GLOBAL_CONFIG.reset()
    chaos.reset()
    reset_registry()


def _run_cfg(tmp_path, name, **kw):
    return RunConfig(name=name, storage_path=str(tmp_path), **kw)


def test_data_parallel_basic(ray_init, tmp_path):
    def train_fn(config):
        from ray_tpu_torch import train

        ctx = train.get_context()
        for step in range(config["steps"]):
            train.report({"step": step, "loss": 1.0 / (step + 1),
                          "rank": ctx.get_world_rank(),
                          "world": ctx.get_world_size()})

    result = DataParallelTrainer(
        train_fn,
        train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=_run_cfg(tmp_path, "basic"),
    ).fit()
    assert result.error is None
    assert result.metrics["world"] == 2
    # 2 workers x 3 steps
    assert len(result.metrics_history) == 6


def test_checkpoint_topk_and_best(ray_init, tmp_path):
    def train_fn():
        from ray_tpu_torch import train

        for step in range(4):
            state = {"w": np.full(4, float(step)), "step": step}
            train.report({"step": step, "loss": [3.0, 1.0, 2.0, 4.0][step]},
                         checkpoint_state=state)

    result = DataParallelTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=_run_cfg(
            tmp_path, "topk",
            checkpoint_config=CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="loss",
                checkpoint_score_order="min"),
        ),
    ).fit()
    assert result.checkpoint is not None
    run_dir = os.path.join(str(tmp_path), "topk")
    kept = sorted(d for d in os.listdir(run_dir) if d.startswith("checkpoint_"))
    assert len(kept) == 2  # latest + best
    # best by min loss is step 1; latest is step 3
    assert kept == ["checkpoint_000000001", "checkpoint_000000003"]
    assert result.best_checkpoint.step == 1
    # both rank shards present and loadable
    state = result.checkpoint.load_state({"w": np.zeros(4), "step": 0}, rank=1)
    assert state["step"] == 3 and state["w"][0] == 3.0


def test_barrier_and_broadcast(ray_init, tmp_path):
    def train_fn():
        from ray_tpu_torch import train

        ctx = train.get_context()
        token = ctx.broadcast_from_rank_zero(
            "coord", "addr-of-rank0" if ctx.get_world_rank() == 0 else None)
        ctx.barrier("start")
        train.report({"token": token, "step": 0})

    result = DataParallelTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=3),
        run_config=_run_cfg(tmp_path, "sync"),
    ).fit()
    toks = {m["token"] for m in result.metrics_history}
    assert toks == {"addr-of-rank0"}


def test_worker_failure_restart_and_resume(ray_init, tmp_path):
    """Kill rank 0 mid-run; controller restarts the group and training
    resumes from the latest finalized checkpoint."""
    marker = str(tmp_path / "died_once")

    def train_fn(config):
        from ray_tpu_torch import train

        ctx = train.get_context()
        start = 0
        ckpt = ctx.get_checkpoint()
        if ckpt is not None:
            state = ckpt.load_state({"w": np.zeros(2), "step": 0},
                                    rank=ctx.get_world_rank())
            start = int(state["step"]) + 1
        for step in range(start, config["steps"]):
            if (step == 2 and ctx.get_world_rank() == 0
                    and not os.path.exists(config["marker"])):
                # die only once a checkpoint has FINALIZED (all ranks'
                # shards promoted), as JAX's test does
                deadline = time.time() + 60
                while time.time() < deadline and not any(
                    n.startswith("checkpoint_")
                    for n in os.listdir(config["run_dir"])
                ):
                    time.sleep(0.1)
                open(config["marker"], "w").close()
                os._exit(1)  # hard kill: actor dies, no cleanup
            train.report(
                {"step": step, "resumed_from": start},
                checkpoint_state={"w": np.ones(2) * step, "step": step},
            )

    result = DataParallelTrainer(
        train_fn,
        train_loop_config={"steps": 5, "marker": marker,
                           "run_dir": str(tmp_path / "phoenix")},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=_run_cfg(
            tmp_path, "phoenix",
            failure_config=FailureConfig(max_failures=2),
        ),
    ).fit()
    assert result.error is None
    assert os.path.exists(marker)
    assert result.metrics["step"] == 4
    # the restarted incarnation resumed from a checkpoint, not from scratch
    resumed = [m for m in result.metrics_history if m.get("resumed_from", 0) > 0]
    assert resumed, "second incarnation should resume from checkpoint"
    assert result.checkpoint.step == 4


def test_failure_budget_exhausted(ray_init, tmp_path):
    def train_fn():
        raise RuntimeError("boom")

    with pytest.raises(TrainingFailedError):
        DataParallelTrainer(
            train_fn,
            scaling_config=ScalingConfig(num_workers=1),
            run_config=_run_cfg(tmp_path, "budget",
                                failure_config=FailureConfig(max_failures=0)),
        ).fit()


def test_torch_trainer_tensor_state_roundtrip(ray_init, tmp_path):
    """TorchTrainer with torch tensor state through snapshot/restore (JAX's
    ``test_jax_trainer_sharded_state_roundtrip`` on torch tensors): a
    second fit of the same run resumes from the first's checkpoint, and
    the driver reads it without torch."""

    def train_fn(config):
        import torch

        from ray_tpu_torch import train

        ctx = train.get_context()
        params = {"w": torch.arange(8.0), "b": torch.zeros(4)}
        start = 0
        ckpt = ctx.get_checkpoint()
        if ckpt is not None:
            state = ckpt.load_state({"params": params, "step": 0})
            start = int(state["step"]) + 1
            params = state["params"]

        for step in range(start, config["steps"]):
            params = {k: v + 1.0 for k, v in params.items()}
            train.report({"step": step, "w0": float(params["w"][0]),
                          "start": start,
                          "is_tensor": torch.is_tensor(params["w"])},
                         checkpoint_state={"params": params, "step": step})

    def fit(steps):
        return TorchTrainer(
            train_fn, train_loop_config={"steps": steps},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=_run_cfg(tmp_path, "torchstate"),
        ).fit()

    result = fit(3)
    assert result.error is None
    assert result.metrics["w0"] == 3.0 and result.metrics["is_tensor"]
    state = result.checkpoint.load_state(
        {"params": {"w": np.zeros(8), "b": np.zeros(4)}, "step": 0})
    np.testing.assert_array_equal(state["params"]["w"], np.arange(8.0) + 3)
    assert state["step"] == 2
    # a new run over the same storage resumes where the checkpoint left off
    again = fit(5)
    assert [m["start"] for m in again.metrics_history] == [3, 3]
    assert again.metrics["w0"] == 5.0


def test_checkpoint_manager_recovers_existing(tmp_path):
    """A new manager over an existing run dir finds prior checkpoints."""
    mgr = CheckpointManager(str(tmp_path), "recover", num_to_keep=3)
    os.makedirs(mgr.staging_dir(0))
    np.savez(os.path.join(mgr.staging_dir(0), "rank_0.npz"), w=np.ones(2))
    assert mgr.finalize(0, {"loss": 1.0}, expected_ranks=1) is not None

    mgr2 = CheckpointManager(str(tmp_path), "recover", num_to_keep=3)
    assert mgr2.latest is not None
    assert mgr2.latest.path == mgr.latest.path


def test_setup_torch_distributed_two_processes(ray_init, tmp_path):
    """Two worker processes join one gloo group through
    ``setup_torch_distributed`` (the env contract of JAX's
    ``setup_jax_distributed``) and all-reduce their ranks; a second call
    initialises again in the same process; after rank 0 dies the
    controller's new gang initialises too."""
    marker = str(tmp_path / "killed")

    def train_fn(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.train import setup_torch_distributed

        ctx = train.get_context()
        restarted = os.path.exists(config["marker"])
        device = setup_torch_distributed()
        ranks = torch.tensor([float(ctx.get_world_rank())])
        dist.all_reduce(ranks)
        backend = dist.get_backend()
        setup_torch_distributed(backend="gloo")  # again, same process
        ones = torch.ones(1)
        dist.all_reduce(ones)
        # no rank may still be inside a collective when rank 0 dies
        ctx.barrier("collectives done")
        if ctx.get_world_rank() == 0 and not restarted:
            open(config["marker"], "w").close()
            os._exit(1)
        train.report({"step": 0, "ranks_sum": float(ranks), "device":
                      str(device), "backend": backend,
                      "world": dist.get_world_size(),
                      "again_sum": float(ones), "restarted": restarted,
                      "rank": ctx.get_world_rank()})

    result = TorchTrainer(
        train_fn, train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=_run_cfg(tmp_path, "dist",
                            failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert os.path.exists(marker)
    second = [m for m in result.metrics_history if m["restarted"]]
    assert sorted(m["rank"] for m in second) == [0, 1]
    for m in result.metrics_history:
        assert m["ranks_sum"] == 1.0 and m["again_sum"] == 2.0
        assert m["world"] == 2 and m["backend"] == "gloo"
        assert m["device"] == "cpu"


def test_use_gpu_workers_get_disjoint_devices(ray_init, tmp_path):
    """``use_gpu``: a worker takes ``{"GPU": 1}`` (one process a device),
    and the two workers' leases hold different devices."""

    def train_fn():
        from ray_tpu_torch import train

        train.report({"step": 0,
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    trainer = TorchTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
        run_config=_run_cfg(tmp_path, "gpus"))
    assert trainer.scaling_config.worker_resources() == {"GPU": 1.0}
    result = trainer.fit()
    seen = sorted(m["visible"] for m in result.metrics_history)
    assert seen == ["0", "1"]
    deadline = time.monotonic() + 30  # the leases return as workers exit
    while rt.available_resources().get("GPU") != 2.0:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)


@pytest.mark.parametrize("field", ["topology", "accelerator_type"])
def test_gang_placement_is_refused(field, tmp_path):
    """Gang placement is no longer refused: as in JAX (``use_tpu_slices =
    use_tpu and topology``), ``topology`` with ``use_gpu`` reserves a whole
    NVLink domain, through the controller into the worker group, while
    ``accelerator_type`` alone reserves none."""
    value = {"topology": "2x4", "accelerator_type": "H100-8"}[field]
    scaling = ScalingConfig(num_workers=2, use_gpu=True, **{field: value})
    assert scaling.use_gpu_domain == (field == "topology")
    controller = TorchTrainer(
        lambda: None, scaling_config=scaling,
        run_config=_run_cfg(tmp_path, "gang"))._controller()
    assert controller.use_gpu_domain == (field == "topology")
    assert (controller.topology, controller.accelerator_type) == (
        (value, "") if field == "topology" else ("", value))
    assert not controller._elastic_live()


def test_driver_of_a_training_run_imports_no_torch(tmp_path):
    """A fresh interpreter: import the train library, the DAG and the
    stage actors' module, fit a 2-worker DataParallelTrainer with a numpy
    train fn and run a compiled DAG; neither torch nor JAX nor the JAX
    package was imported by the driver."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import ray_tpu_torch as rt\n"
        "import ray_tpu_torch.cluster_utils, ray_tpu_torch.util.placement_group\n"
        "import ray_tpu_torch.train.pipeline_actors\n"
        "from ray_tpu_torch.dag import InputNode\n"
        "from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,\n"
        "                                 ScalingConfig, report)\n"
        "rt.init(num_cpus=4)\n"
        "def fn():\n"
        "    report({'step': 0}, checkpoint_state={'w': np.ones(2)})\n"
        "r = DataParallelTrainer(fn, scaling_config=ScalingConfig(\n"
        "    num_workers=2), run_config=RunConfig(name='n', storage_path=\n"
        f"    {str(tmp_path)!r})).fit()\n"
        "assert r.checkpoint.load_state({'w': np.zeros(2)})['w'][0] == 1\n"
        "A = rt.remote(type('A', (), {'f': lambda self, x: x + 1}))\n"
        "a = A.remote()\n"
        "with InputNode() as inp:\n"
        "    c = a.f.bind(inp).experimental_compile()\n"
        "assert c.execute(1).get(timeout=60) == 2\n"
        "c.teardown()\n"
        "rt.shutdown()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('torch', 'jax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_placement_group_bundles_hold_whole_gpus(ray_init):
    """``util.placement_group`` on the port's control store: two 1-GPU
    bundles commit, an actor in each sees its own device, the group's
    removal returns them. A fractional GPU bundle commits, as the JAX
    package's fractional TPU bundle does, and an actor holding half a GPU
    in it binds no device: it sees the node's (the name is kept from when
    such a bundle raised)."""
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    @rt.remote
    class Probe:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    pg = placement_group([{"GPU": 1}, {"GPU": 1}], strategy="SPREAD")
    assert pg.ready(timeout=60) and pg.bundle_count == 2
    assert len(pg.bundle_placements()) == 2
    probes = [Probe.options(num_gpus=1, placement_group=pg,
                            placement_group_bundle_index=i).remote()
              for i in range(2)]
    seen = sorted(rt.get([p.visible.remote() for p in probes], timeout=60))
    assert seen == ["0", "1"]
    for p in probes:
        rt.kill(p)
    remove_placement_group(pg)
    half = placement_group([{"GPU": 0.5}, {"GPU": 0.5}])
    assert half.ready(timeout=60)
    probes = [Probe.options(num_gpus=0.5, num_cpus=0, placement_group=half,
                            placement_group_bundle_index=i).remote()
              for i in range(2)]
    assert rt.get([p.visible.remote() for p in probes], timeout=60) == [
        None, None]
    for p in probes:
        rt.kill(p)
    remove_placement_group(half)


def test_fractional_gpu_workers_share_the_node(ray_init, tmp_path):
    """``resources_per_worker={"GPU": 0.5}``: two workers of a gang hold
    half a GPU each, bind no device and see the node's, as the JAX
    package's ``{"TPU": 0.5}`` workers do; the halves return when the run
    ends."""

    def train_fn():
        from ray_tpu_torch import train

        train.report({"step": 0,
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    trainer = TorchTrainer(
        train_fn, scaling_config=ScalingConfig(
            num_workers=2, resources_per_worker={"GPU": 0.5, "CPU": 1}),
        run_config=_run_cfg(tmp_path, "half_gpus"))
    result = trainer.fit()
    assert [m["visible"] for m in result.metrics_history] == [None, None]
    deadline = time.monotonic() + 30
    while rt.available_resources().get("GPU") != 2.0:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)


def test_sim_nodes_join_a_cluster_and_leave_with_it():
    """``Cluster.add_sim_nodes`` (JAX's ``cluster_utils.py:100``): 8
    simulated nodes with the resources asked for, labelled ``simnode``,
    beside the real head; ``shutdown`` ends the plane's process."""
    import asyncio

    from ray_tpu_torch._private import protocol as pb
    from ray_tpu_torch._private.protocol import ResourceSet
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.runtime.rpc import RpcClient

    cluster = Cluster(initialize_head=True)
    try:
        handle = cluster.add_sim_nodes(8, seed=11,
                                       resources={"CPU": 8, "GPU": 1})
        assert handle.count == 8 and len(set(handle.node_ids)) == 8

        async def nodes():
            client = RpcClient(cluster.address, name="test->cs")
            await client.connect()
            try:
                return (await client.call("get_all_nodes", {}))["nodes"]
            finally:
                await client.close()

        deadline = time.monotonic() + 30
        while True:
            alive = [n for n in asyncio.run(nodes())
                     if n["state"] == pb.NODE_ALIVE]
            if len(alive) == 9:
                break
            assert time.monotonic() < deadline, len(alive)
            time.sleep(0.2)
        sims = [n for n in alive if n["labels"].get("simnode") == "true"]
        assert sorted(n["node_id"] for n in sims) == sorted(
            bytes.fromhex(h) for h in handle.node_ids)
        assert all(ResourceSet.from_wire(n["resources"]).to_dict()
                   == {"CPU": 8.0, "GPU": 1.0} for n in sims)
    finally:
        cluster.shutdown()
    assert handle.proc.wait(timeout=30) is not None
    assert cluster.sim_planes == []
