"""The port's collective groups (``ray_tpu_torch.util.collective``, gloo on
the CPU) against the JAX package's (``ray_tpu.util.collective``, backend
"xla" on CPU jax), and the cases of ``test_collective_tpu.py`` on the port.

The same seeded numpy inputs go through a 3-rank JAX group on a JAX cluster
in the pytest worker and a 3-rank port group on a port cluster in the torch
child (``_port_side.col_start``), side by side; every op must agree
bitwise. Both clusters run ``_col_cases`` (shipped by value). Added: the
input is never written, the refused backends, two groups beside a
``setup_torch_distributed`` default group, and world 1.
"""

import gc
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import numpy as np
import pytest

import _col_cases
import _port_proc
import ray_tpu

cloudpickle.register_pickle_by_value(_col_cases)

WORLD = 3


@pytest.fixture(scope="module")
def port():
    with _port_proc.spawn(timeout=240) as call:
        call("col_start", 8, WORLD)
        yield call


def _inputs(seed):
    out = []
    for r in range(WORLD):
        rng = np.random.default_rng(seed + r)
        out.append({
            "x": rng.standard_normal((WORLD, 257)).astype(np.float32),
            "xi": rng.integers(-1000, 1000, (33,)).astype(np.int32),
        })
    return out


def _jax_ops(inputs):
    """``_col_cases.parity_ops`` on a 3-rank XLA group of a JAX cluster,
    with the cyclic GC off: garbage of earlier tests is collected before
    the cluster starts and this one's after it ends, so no ObjectRef
    finaliser runs inside the JAX package's ReferenceCounter lock (its
    deadlock, ROADMAP Queue 3)."""
    gc.collect()
    gc.disable()
    ray_tpu.init(num_cpus=WORLD + 1)
    try:
        member = ray_tpu.remote(num_cpus=1)(_col_cases.Member)
        members = [member.remote(r, "ray_tpu") for r in range(WORLD)]
        fn = cloudpickle.dumps(_col_cases.parity_ops)
        return ray_tpu.get([m.call.remote(fn, WORLD, "xla", "parity", inputs)
                            for m in members], timeout=180)
    finally:
        ray_tpu.shutdown()
        gc.enable()
        gc.collect()


def test_collective_ops_match_jax_bitwise(port):
    """allreduce (sum, product, max, min; int32), reduce, broadcast,
    allgather, reducescatter (each op), permute (a ring, one pair), and the
    bytes of send/recv: the port's gloo group gives JAX's XLA group's
    results bit for bit, on every rank."""
    inputs = _inputs(17)
    with ThreadPoolExecutor(1) as pool:  # the two clusters side by side
        port_side = pool.submit(port, "col_run", "parity_ops", WORLD, WORLD,
                                "gloo", "parity", inputs)
        want = _jax_ops(inputs)
        ported = port_side.result()
    for rank in range(WORLD):
        assert sorted(ported[rank]) == sorted(want[rank])
        for name, value in want[rank].items():
            got = ported[rank][name]
            if name == "recv":
                assert got == value, (rank, name)
                continue
            assert got.dtype == value.dtype and got.shape == value.shape, (
                rank, name, got.dtype, got.shape, value.dtype, value.shape)
            assert got.tobytes() == value.tobytes(), (rank, name)
    # the reductions are real ones: float sums differ from a plain
    # np.sum in some bits, and reducescatter's chunk j is rank j's
    xs = [i["x"] for i in inputs]
    np.testing.assert_allclose(ported[1]["reducescatter_sum"],
                               sum(x[1] for x in xs), rtol=1e-5)
    assert not ported[0]["permute_one"].any()  # rank 0 is no destination
    np.testing.assert_array_equal(ported[WORLD - 1]["permute_one"], xs[0][1])


def test_collective_allreduce_multiprocess(port):
    results = port("col_run", "port_allreduce_multiprocess", WORLD, WORLD,
                   "g1")
    for s, bc, ag, rs in results:
        assert s == [30.0, 33.0, 36.0, 39.0]
        assert bc == [1.0, 1.0]            # broadcast from rank 1
        assert ag == [0.0, 1.0, 2.0]
        assert rs == [3.0, 3.0]            # sum of per-rank constants 0+1+2


def test_collective_tensors_in_tensors_out(port):
    """A tensor in gives a tensor out (bf16 kept), and an ObjectRef of a
    tensor this process put resolves through rdt to the tensor itself."""
    out = port("col_run", "port_tensors", 2, 2, "dev")
    for r in out:
        assert r["types"] == ["Tensor"] * 5
        assert r["dtypes"] == ["torch.float32", "torch.bfloat16",
                               "torch.bfloat16", "torch.float32"]
        assert r["doubled"] == [20.0, 24.0, 28.0, 32.0]  # 2 * sum(arange+10r)
        assert r["bf16"] == [10.0, 12.0, 14.0, 16.0]
        assert r["s2"] == [3.0, 3.0, 3.0]                 # ranks 1+2
        assert r["rdt_hits"] == 1
        assert r["ag"] == [[0.0, 1.0, 2.0, 3.0], [10.0, 11.0, 12.0, 13.0]]
    assert [r["rs"] for r in out] == [[10.0, 12.0, 14.0, 16.0]] * 2


def test_collective_send_recv(port):
    a, b = port("col_run", "port_send_recv", 2, "p2p")
    assert a is None
    assert b == ("ndarray", [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]], "Tensor",
                 "torch.bfloat16", "cpu", [0.0, 0.25, 0.5, 0.75])


def test_reducescatter_and_permute(port):
    out = port("col_run", "port_reducescatter_permute", 2, 2, "rs")
    for rank, (rs, swap, errors) in enumerate(out):
        # reduced chunk j on rank j: sum_r (r + j) = world*j + sum(r)
        assert rs == [float(2 * rank + 1)] * 2, (rank, rs)
        assert swap == [float(1 - rank)] * 2
        assert errors == [
            "permute pair (0, 2) out of range for world size 2",
            "permute destination 1 appears twice",
            "reducescatter input leading dim must be world_size 2, got "
            "(3, 2)"]


def test_device_channel_stage_handoff(port):
    err, (got, np_typed) = port("col_run", "port_device_channel", 2, "edge01")
    assert [g[3] for g in got] == [1.0, 2.0, 3.0]
    assert {g[:3] for g in got} == {("Tensor", "torch.bfloat16", "cpu")}
    assert {g[4] for g in got} == {(4, 8)}
    assert np_typed == ("torch.float32", [5.0, 6.0])
    assert err == ("device channel is typed (4, 8)/torch.bfloat16; got "
                   "(4, 9)/torch.bfloat16")


def test_inputs_unchanged_after_each_op(port):
    for same in port("col_run", "port_inputs_unchanged", 2, 2, "keep"):
        assert same == {k: (True, True) for k in (
            "allreduce", "reduce", "broadcast", "allgather",
            "reducescatter", "permute")}


def test_backends_refused_on_this_container(port):
    """backend="xla" names both of the port's backends; "nccl" needs CUDA,
    which this container has not (the JAX package refuses "nccl")."""
    out = port("col_run", "port_refusals", 1)[0]
    kind, msg = out["xla"]
    assert kind == "ValueError" and "'nccl'" in msg and "'gloo'" in msg
    kind, msg = out["nccl"]
    assert kind == "RuntimeError" and "CUDA" in msg
    from ray_tpu.util.collective.collective import _manager

    with pytest.raises(ValueError, match="NCCL is not available"):
        _manager.create(1, 0, "nccl", "refused")


def test_groups_beside_default_group(port, tmp_path):
    """Two collective groups beside the default group of a 2-worker
    TorchTrainer: destroying one leaves the other and the default group
    working, and none of them touches the default group."""
    history = port("col_groups_beside_default", str(tmp_path), "beside")
    assert sorted(m["rank"] for m in history) == [0, 1]
    for m in history:
        assert m["before"] == [3.0, 3.0] and m["after_b"] == 3.0
        assert m["default"] == 3.0 and m["default_after"] == 2.0
        assert m["a_alive"] is False and m["default_alive"] is True


def test_world_one_returns_what_jax_returns(port):
    x = np.arange(6, dtype=np.float32).reshape(1, 6)
    want = _col_cases.world_one(0, "ray_tpu", "xla", "world-one", x)
    got = port("col_world_one", x)
    assert sorted(got) == sorted(want)
    for name, (same, value) in want.items():
        assert got[name][0] == same, name
        np.testing.assert_array_equal(got[name][1], value)
        assert got[name][1].shape == value.shape, name


def test_backend_collectives_outside_a_cluster(port):
    """Ranks that share no cluster (``RT_COLLECTIVE_COORD`` names the
    store) take the process group's own collectives, the reduce-scatter
    included: each op exactly its numpy twin on integer-valued data, for
    numpy and CPU tensors, inputs unchanged."""
    out = port("col_backend_path", 3)
    assert sorted(out) == [0, 1, 2]
    for rank, got in out.items():
        assert len(got) == 2 * 12 and all(got.values()), (rank, got)
