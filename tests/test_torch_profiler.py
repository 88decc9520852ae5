"""The port's profiler (``ray_tpu_torch/gpu/profiler.py``) against the JAX
package's ``test_observability.py::test_jax_profiler_capture``: a capture
on a cluster node writes a trace, here a ``torch.profiler`` chrome trace
of the CPU. Beside it, ``capture_local`` around a workload records the
workload's operators, and ``init_profiler``'s listener makes
``capture_on_node(..., port=)`` trace the process that started it (an
actor) rather than the capturing task's worker. The port's side imports
torch, so it runs in the ``_port_proc`` child.
"""

import json
import os

import pytest

import _port_proc


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    root = tmp_path_factory.mktemp("prof")
    with _port_proc.spawn(timeout=240) as call:
        yield call("profiler_captures", str(root)), root


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_torch_profiler_capture(captured):
    """As JAX's test: capture_on_node into a given logdir writes a trace."""
    got, root = captured
    files = got["files"]
    assert files, "no trace files produced"
    assert all(f.startswith(str(root / "prof")) for f in files), files
    assert any("trace" in f and f.endswith(".json") for f in files), files
    assert isinstance(_trace_events(files[0]), list)


def test_capture_local_records_the_workload(captured):
    got, _ = captured
    assert len(got["local"]) == 1 and got["local_mm"]
    assert f"trace_{got['pid']}_" in os.path.basename(got["local"][0])


def test_init_profiler_traces_the_listening_process(captured):
    """A capture through the listener is of the actor's process, in a temp
    dir made on the node (logdir=None); a second init_profiler returns the
    first's port."""
    got, _ = captured
    assert got["port"] > 0 and got["again"] == got["port"]
    files = got["actor_files"]
    assert len(files) == 1, files
    assert f"trace_{got['actor_pid']}_" in os.path.basename(files[0])
    assert "rt_torchprof_" in files[0]
    assert isinstance(_trace_events(files[0]), list)
