"""The port's own spans (``ray_tpu_torch/util/tracing.py``'s local buffer)
inside the paged engine and the train step: what each span holds, that
nothing records with tracing off, that a profiler's spans meet the
buffer's on the trace's clock (``portbench/progspans.py``), and that the
engine's request queues and metrics are touched only from its loop's
thread. Torch runs in a spawned child (``_port_proc``)."""

import subprocess
import sys
from collections import defaultdict

import numpy as np
import pytest

from _port_proc import spawn

SHAPE = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=128, max_seq_len=256)
ECFG = dict(max_num_seqs=3, kv_block_size=4, num_kv_blocks=64,
            max_model_len=64)
PROMPTS = [[1, 5, 9], [3, 3, 3, 7, 2, 8, 8, 1, 4, 6, 2], [42], [7, 7, 1, 2]]
TOKENS = np.random.RandomState(0).randint(0, 512, size=(2, 16)).astype(
    np.int64)

STEP, ADMIT = "engine.step", "engine.admit"
REQUEST = ("engine.queue", "engine.admit", "engine.prefill",
           "engine.first_token")


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        yield call


@pytest.fixture(scope="module")
def traced(port):
    return port("engine_spans", SHAPE, ECFG, PROMPTS, 6)


def _named(spans, name):
    return sorted((s for s in spans if s["name"] == name),
                  key=lambda s: s["start_ns"])


def test_one_step_span_a_step_with_the_engines_state(traced):
    steps = _named(traced["spans"], STEP)
    assert len(steps) == traced["steps"] == len(traced["seen"]) > 0
    assert [s["attrs"]["step"] for s in steps] == list(range(len(steps)))
    for s, (active, cached) in zip(steps, traced["seen"]):
        assert (s["attrs"]["active"], s["attrs"]["cached"]) == (active, cached)
        assert s["attrs"]["gathered"] == traced["gathered"] == 3 * 64
    # launch and sync sit inside their step, on the worker thread
    for inner in ("engine.launch", "engine.sync"):
        got = _named(traced["spans"], inner)
        assert len(got) == len(steps)
        for s, i in zip(steps, got):
            assert s["start_ns"] <= i["start_ns"] <= i["end_ns"] <= s["end_ns"]
            assert i["thread"] == s["thread"]


def test_request_spans_share_the_request_id(traced):
    by_rid = defaultdict(set)
    for name in REQUEST:
        for s in _named(traced["spans"], name):
            by_rid[s["attrs"]["rid"]].add(name)
    assert sorted(by_rid) == [1, 2, 3, 4]
    assert all(names == set(REQUEST) for names in by_rid.values())
    for s in _named(traced["spans"], "engine.prefill"):
        assert 0 < s["attrs"]["tokens"] <= s["attrs"]["padded"]
        assert s["attrs"]["cached_len"] == 0
    # an attempt that found no slot carries the request id alone; the one
    # that admitted carries its blocks
    admitted = [s for s in _named(traced["spans"], ADMIT)
                if "new_blocks" in s["attrs"]]
    assert sorted(s["attrs"]["rid"] for s in admitted) == [1, 2, 3, 4]
    for s in admitted:
        assert s["attrs"]["new_blocks"] > 0 and s["attrs"]["hit_blocks"] == 0
        assert s["attrs"]["evicted"] == 0
    # a request's queue span ends as the attempt that admits it starts
    queue = {s["attrs"]["rid"]: s for s in _named(traced["spans"],
                                                  "engine.queue")}
    for s in admitted:
        assert queue[s["attrs"]["rid"]]["end_ns"] <= s["start_ns"]
        assert queue[s["attrs"]["rid"]]["manual"]


def test_each_emit_lies_between_its_step_and_the_next(traced):
    steps = _named(traced["spans"], STEP)
    emits = _named(traced["spans"], "engine.emit")
    assert [e["attrs"]["step"] for e in emits] == list(range(len(steps)))
    assert sum(e["attrs"]["tokens"] for e in emits) == sum(
        s["attrs"]["active"] for s in steps)
    for k, e in enumerate(emits):
        assert steps[k]["end_ns"] <= e["start_ns"]
        if k + 1 < len(steps):
            assert e["end_ns"] <= steps[k + 1]["start_ns"]
        assert e["thread"] != steps[k]["thread"]  # the loop's, not the worker's


def test_loop_spans_tile_the_loop(traced):
    """Every loop iteration is a turn; waits name what they wait for."""
    waits = _named(traced["spans"], "engine.wait")
    whats = {w["attrs"]["what"] for w in waits}
    assert {"step", "admit", "yield"} <= whats
    assert sum(w["attrs"]["what"] == "step" for w in waits) == traced["steps"]
    turns = _named(traced["spans"], "engine.turn")
    assert len(turns) >= traced["steps"]
    for w in waits:
        if w["attrs"]["what"] != "yield":
            assert any(t["start_ns"] <= w["start_ns"] <= w["end_ns"]
                       <= t["end_ns"] for t in turns)


def test_forced_collection_is_a_span(traced):
    assert traced["gc"]
    g = traced["gc"][-1]
    assert g["attrs"]["generation"] == 2 and g["attrs"]["collected"] >= 0
    assert g["end_ns"] >= g["start_ns"]


def test_train_step_spans_in_order(port):
    spans = port("train_spans", SHAPE, TOKENS, 2)
    steps = _named(spans, "train.step")
    assert len(steps) == 2
    for st in steps:
        inner = sorted((s for s in spans if s["name"] != "train.step"
                        and st["start_ns"] <= s["start_ns"]
                        and s["end_ns"] <= st["end_ns"]),
                       key=lambda s: s["start_ns"])
        assert [s["name"] for s in inner] == [
            "train.forward", "train.backward", "train.optimizer"]
        for a, b in zip(inner, inner[1:]):
            assert a["end_ns"] <= b["start_ns"]


def test_nothing_records_with_tracing_off(port):
    spans, entered = port("spans_off", SHAPE, ECFG, PROMPTS, TOKENS)
    assert spans == []
    # torch's optimizer enters its own on each step: the count works
    assert entered and all(n.startswith("Optimizer.") for n in entered)


def test_profiler_records_spans_onto_the_traces_clock(port, tmp_path):
    names, dists, residual, split = port(
        "spans_profiled", SHAPE, ECFG, PROMPTS[:2], 6, str(tmp_path))
    assert {"engine.step", "engine.launch", "engine.turn",
            "engine.admit"} <= set(names)
    mapped = {d[0] for d in dists}
    assert {"engine.step", "engine.launch", "engine.sync",
            "engine.admit", "engine.prefill"} <= mapped
    # each end lands within 100 us of its annotation's; a shared CPU
    # preempts a thread between a clock read and the profiler's now and
    # then (a lone record_function's entry takes up to ~1 ms here), so a
    # tenth may fall outside, and the typical distance is far inside
    far = [d for d in dists if max(d[1:]) > 100.0]
    assert len(far) <= 0.1 * len(dists), (far, len(dists), residual)
    assert sorted(max(d[1:]) for d in dists)[len(dists) // 2] <= 25.0, dists
    # a CPU trace has no kernels: the whole stretch is device idle, and
    # the worker's and the loop's spans cover nearly all of it
    assert split["idle_s"] > 0
    assert split.get("not covered", 0.0) <= 0.1 * split["idle_s"]


def test_queues_and_metrics_only_on_the_loop_thread(port):
    ecfg = dict(ECFG, kv_block_size=4, prefix_cache=True)
    prompts = [list(range(1, 14)), list(range(1, 12)) + [40, 41]]
    got = port("engine_threads", SHAPE, ecfg, prompts)
    assert got["put"] == [got["loop"]] and got["metric"] == [got["loop"]]
    assert got["again"] == got["local"] == got["moved"]
    assert got["stats"]["prefix_cache"]["block_hits"] > 0
    assert got["stats"]["active_slots"] == 0


def test_tracing_imports_no_torch():
    code = ("import sys, ray_tpu_torch.util.tracing as t; "
            "t.recording(); "
            "assert 'torch' not in sys.modules, 'torch loaded'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
