"""Gang placement on an NVLink domain (``ray_tpu_torch/gpu/slice.py``, the
port's ``ray_tpu/tpu/slice.py``): detection and labels of a domain, the
cross-domain env, the topology placement strategy
(``test_cluster.py::test_topology_strict_pack_picks_contiguous_hosts``), a
domain reservation and its dispatch
(``test_collective_tpu.py::test_slice_placement_group``) and a
``TorchTrainer`` with ``ScalingConfig(use_gpu=True, topology=...)`` on a
fake domain. The runtime and the train library import no torch, so these
run in the pytest worker (fake GPUs: resources, no devices).
"""

import socket
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.gpu import accelerator as acc
from ray_tpu_torch.gpu.slice import (
    SlicePlacementGroup,
    get_gpu_coordinator_env_vars,
    slice_placement_group,
)
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from ray_tpu_torch.util.placement_group import (
    placement_group,
    remove_placement_group,
)

POD = "fake-16"          # the domain: 4 hosts of 4 fake GPUs
COORDS = ("0,0", "0,1", "7,7", "0,2")


@pytest.fixture(scope="module")
def domain():
    """A cluster of the port whose 4 extra nodes form one NVLink domain,
    host 0 at 0,0 holding the domain's head resource; 7,7 is far away."""
    c = Cluster()
    nodes = {}
    for i, coord in enumerate(COORDS):
        resources = {"CPU": 2, "GPU": 4}
        if i == 0:
            resources[f"GPU-{POD}-head"] = 1
        nodes[coord] = c.add_node(resources=resources, labels={
            "rt.gpu.coord": coord, "gpu-domain-name": "dom0",
            "gpu-pod-type": POD, "gpu-worker-id": str(i),
            "gpu-topology": "4x4"})
    rt.init(address=c.address)
    yield {nodes[k].node_id: k for k in nodes}
    rt.shutdown()
    c.shutdown()


@pytest.fixture(autouse=True)
def _reset_port_config():
    yield
    GLOBAL_CONFIG.reset()


def _domain_free():
    """Wait until the domain's devices and head are free again: an earlier
    test's leases and reservations return asynchronously, and a placement
    made meanwhile takes the free hosts it finds."""
    want = {"GPU": 4.0 * len(COORDS), f"GPU-{POD}-head": 1.0}
    deadline = time.monotonic() + 60
    while any(rt.available_resources().get(k) != v for k, v in want.items()):
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)


def test_gpu_domain_detection_from_env(monkeypatch):
    """``test_collective_tpu.py::test_tpu_detection_from_env``: the domain
    from the flag and env, the head resource on host 0 only."""
    devs = [(i, "NVIDIA H100 80GB HBM3", f"GPU-{i}") for i in range(8)]
    monkeypatch.setattr(acc, "_nvidia_smi", lambda: devs)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("GPU_DOMAIN_NAME", "nvl-a")
    monkeypatch.setenv("GPU_WORKER_ID", "0")
    GLOBAL_CONFIG.apply_system_config({"gpu_topology": "2x8"})
    info = acc.GpuAcceleratorManager.detect(allow_cuda_probe=False)
    assert info.pod_type == "H100-16"
    res, labels = acc.GpuAcceleratorManager.node_resources_and_labels(info)
    assert res == {"GPU": 8.0, "GPU-H100-16-head": 1.0}
    assert labels["gpu-domain-name"] == "nvl-a"
    assert labels["gpu-topology"] == "2x8" and labels["gpu-pod-type"] == "H100-16"
    assert labels["rt.gpu.coord"] == "0,0"
    monkeypatch.setenv("GPU_WORKER_ID", "1")
    res2, labels2 = acc.GpuAcceleratorManager.node_resources_and_labels(
        acc.GpuAcceleratorManager.detect(allow_cuda_probe=False))
    assert "GPU-H100-16-head" not in res2
    assert labels2["gpu-worker-id"] == "1" and labels2["rt.gpu.coord"] == "0,1"
    # no configuration: the node is a domain of its own
    GLOBAL_CONFIG.reset()
    monkeypatch.delenv("GPU_DOMAIN_NAME")
    monkeypatch.delenv("GPU_WORKER_ID")
    res3, labels3 = acc.GpuAcceleratorManager.node_resources_and_labels(
        acc.GpuAcceleratorManager.detect(allow_cuda_probe=False))
    assert res3 == {"GPU": 8.0, "GPU-H100-8-head": 1.0}
    assert labels3["gpu-topology"] == "1x8"
    assert labels3["gpu-domain-name"] == (
        f"H100-8-{socket.gethostname()}-0-1-2-3-4-5-6-7")
    with pytest.raises(ValueError, match="HxG"):
        acc.parse_topology("4x")
    assert [acc.model_of(n) for n in (
        "NVIDIA A100-SXM4-80GB", "Tesla V100-SXM2-16GB",
        "NVIDIA GeForce RTX 4090", "")] == ["A100", "V100", "4090", "gpu"]


def test_domain_coordinator_env():
    """``test_collective_tpu.py::test_megascale_env``."""
    assert get_gpu_coordinator_env_vars("h:1", 1, 0) == {}
    env = get_gpu_coordinator_env_vars("head:8081", 4, 2)
    assert env == {"RT_GPU_DOMAIN_COORDINATOR": "head:8081",
                   "RT_GPU_NUM_DOMAINS": "4", "RT_GPU_DOMAIN_ID": "2",
                   "RT_GPU_DOMAIN_PORT": "8081"}


def test_topology_strict_pack_picks_contiguous_hosts(domain):
    """``test_cluster.py::test_topology_strict_pack_picks_contiguous_hosts``
    (the port's control store refused the strategy before): bundles land
    on the hosts forming the tightest block of coordinates, rank-ordered
    row-major — never on the distant host though it has room."""
    _domain_free()
    pg = placement_group([{"GPU": 4}] * 3, strategy="TOPOLOGY_STRICT_PACK")
    assert pg.ready(timeout=60)
    placements = pg.bundle_placements()
    assert [domain[placements[i]] for i in range(3)] == [
        "0,0", "0,1", "0,2"], placements
    remove_placement_group(pg)


def test_slice_placement_group(domain):
    """``test_collective_tpu.py::test_slice_placement_group`` at the
    domain's 3 nearest hosts: the head reserved, the gang pinned to the
    domain, one dispatch a host in coordinate order."""
    _domain_free()
    spg = slice_placement_group(POD, topology="3x4")
    assert (spg.hosts_per_slice, spg.gpus_per_host) == (3, 4)
    assert spg.ready(timeout=60)
    assert spg._slice_names == ["dom0"]   # pinned to the head's domain

    def whoami():
        import os

        return os.environ.get("RT_NODE_ID", "?")

    out = rt.get(spg.dispatch(whoami), timeout=120)
    assert [domain.get(n) for n in out] == ["0,0", "0,1", "0,2"]
    spg.remove()
    with pytest.raises(ValueError, match="disagrees"):
        slice_placement_group(POD, topology="3x4", hosts_per_slice=2)
    with pytest.raises(ValueError, match="pod type"):
        slice_placement_group("", topology="1x1")
    one = SlicePlacementGroup(pod_type=POD, gpus_per_host=4).reserve()
    assert one.ready(timeout=60)
    one.remove()


def test_scaling_config_topology_trains_on_a_domain(domain, tmp_path):
    """``ScalingConfig(use_gpu=True, topology=..., accelerator_type=...)``
    reserves the domain and trains: 6 workers (one GPU each) fill its 3
    nearest hosts two a host, ranks in coordinate order; the reservation
    is released after the run."""
    _domain_free()

    def train_fn():
        import os

        from ray_tpu_torch import train

        ctx = train.get_context()
        train.report({"step": 0, "rank": ctx.get_world_rank(),
                      "node": os.environ.get("RT_NODE_ID")})

    result = TorchTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=6, use_gpu=True,
                                     topology="3x4", accelerator_type=POD),
        run_config=RunConfig(name="domain", storage_path=str(tmp_path)),
    ).fit()
    hosts = {m["rank"]: domain[m["node"]] for m in result.metrics_history}
    assert hosts == {0: "0,0", 1: "0,0", 2: "0,1", 3: "0,1", 4: "0,2",
                     5: "0,2"}
    head = f"GPU-{POD}-head"
    deadline = time.monotonic() + 30  # the reservation returns as it ends
    while rt.available_resources().get(head) != 1.0:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)
    with pytest.raises(Exception, match="fill the 3 hosts"):
        TorchTrainer(
            train_fn,
            scaling_config=ScalingConfig(num_workers=4, use_gpu=True,
                                         topology="3x4", accelerator_type=POD),
            run_config=RunConfig(name="uneven", storage_path=str(tmp_path)),
        ).fit()


def test_jax_slice_placement_refuses_its_own_topology():
    """The JAX package's worker group calls ``slice_placement_group(...,
    topology=...)`` (``ray_tpu/train/_worker_group.py``), which takes no
    ``topology``: ``ScalingConfig(use_tpu=True, topology=...)`` fails there
    before it touches a cluster (ROADMAP Queue 3). The port's takes it."""
    import inspect

    from ray_tpu.tpu.slice import slice_placement_group as jax_spg

    with pytest.raises(TypeError, match="topology"):
        jax_spg(pod_type="v5e-16", num_slices=1, topology="4x4")
    assert "topology" in inspect.signature(slice_placement_group).parameters
