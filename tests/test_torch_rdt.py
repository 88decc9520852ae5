"""The port's device object plane (``ray_tpu_torch/experimental/rdt.py``)
against ``test_rdt.py`` and ``test_round3_fixes.py::test_rdt_*``: a tensor
put into the object plane stays registered in its producer, a get there
returns the tensor itself; a dropped tensor, another process, or a tensor
written since the put rebuild from the put-time host bytes. The torch side
runs in the spawned child; the JAX side of the parity case in the worker.
"""

import gc

import numpy as np
import pytest

import _port_proc


@pytest.fixture(scope="module")
def port():
    with _port_proc.spawn(timeout=180) as call:
        yield call


@pytest.fixture(scope="module")
def rdt(port):
    return port("rdt_cases")


def test_same_process_roundtrip_is_zero_copy(rdt):
    assert rdt["same_process_is"] == (True, True)  # fp32 and bf16


def test_cross_process_rebuild_matches(rdt):
    # the producer's tensor dropped: the weak reference is dead, so the get
    # rebuilds from the host staging bytes (bf16 kept, numpy has none)
    assert rdt["dropped_rebuild"] == ("Tensor", "torch.bfloat16", True)


def test_pytree_with_device_arrays(rdt):
    assert rdt["pytree"] == ("adam", 7, True)


def test_disabled_flag_falls_back(rdt):
    # nothing registered, an equal tensor rebuilt (not the original)
    assert rdt["flag_off"] == (True, False, True)


def test_through_object_plane_tasks(port):
    out = port("rdt_cluster")
    assert out["task"] == (True, 3.0 * 64 * 64, True)
    assert out["driver"] == ("Tensor", 3.0)
    assert out["put_get_is"] is True and out["hit"] == 1
    assert out["after_add"] == (False, True)


@pytest.fixture(scope="module")
def changed(port):
    return port("rdt_changed_since_put")


REBUILD = {"registered": 0, "device_hits": 0, "host_rebuilds": 1}


def test_rdt_live_buffer_returned_same_process(changed):
    assert changed["untouched"] == (True, True, {
        "registered": 0, "device_hits": 1, "host_rebuilds": 0})


@pytest.mark.parametrize("case", ["add_", "optimizer", "storage_freed",
                                  "data_swapped", "view_of_base"])
def test_rdt_changed_tensor_falls_back_to_host(changed, case):
    """The counterpart of ``test_rdt_deleted_buffer_falls_back_to_host``: a
    jax.Array is immutable and only its deletion matters; a tensor written
    in place (directly, by an optimizer step on its parameter, through its
    base), swapped or freed since the put is rebuilt from the put-time
    bytes, never returned."""
    assert changed[case] == (False, True, REBUILD)


def test_stats_count_as_jax_does(port):
    """One program through both packages' serializers: put-time
    registration, a same-process hit, a dropped producer's rebuild; the
    JAX package's counters move as the port's."""
    import jax.numpy as jnp

    from ray_tpu._private import serialization as ser
    from ray_tpu.experimental.rdt import device_object_manager

    stats = device_object_manager().stats
    before = dict(stats)
    x = jnp.arange(64.0)
    blob = ser.serialize(x).to_bytes()
    assert ser.deserialize(blob, copy_buffers=True) is x
    del x
    gc.collect()
    np.testing.assert_array_equal(
        np.asarray(ser.deserialize(blob, copy_buffers=True)), np.arange(64.0))
    want = {k: stats[k] - before[k] for k in stats}
    assert port("rdt_stats_program") == want == {
        "registered": 1, "device_hits": 1, "host_rebuilds": 1}
