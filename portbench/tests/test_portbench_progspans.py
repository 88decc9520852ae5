"""The metrics that read the program's own spans (``progspans.py``), in tiny
traced runs on the CPU: each reads a value, ``decode_useful`` equals the
share that the harness's own decode spans give, and the device-time
readers of the train step's spans count the kernels launched inside
them."""

import pytest
import torch

from conftest import SERVE, TRAIN

import devtrace
import progspans
import run as harness

SEED = 2**32 + 11


@pytest.fixture
def traces(monkeypatch):
    """The runs' traces, as the harness reads them."""
    got = []

    class Kept(devtrace.Trace):
        def __init__(self, path):
            super().__init__(path)
            got.append(self)

    monkeypatch.setattr(devtrace, "Trace", Kept)
    return got


def _new(name):
    bench = harness.load_bench()
    old = {"batch_occupancy.serve", "prefill_share.serve", "ttft_p95_ms.host",
           "itl_p95_ms.host", "decode_step_ms.serve", "decode_step_ms.host",
           "decode_hbm_share.serve", "k1_roofline.serve", "mfu.serve",
           "device_idle.serve", "device_idle.host", "optimizer_ms.train",
           "k1_roofline.train", "k23_roofline.train", "mfu.train",
           "device_idle.train"}
    return [m for m in harness.cell_metrics(bench, name, True) if m not in old]


@pytest.mark.parametrize("name,suffix", [("mistral7b.chat.long", "serve"),
                                         ("mistral7b.chat.short", "host")])
def test_serve_metrics_read_the_programs_spans(name, suffix, traces):
    res = harness.run_cell(name, SEED, 1.5, True, torch.device("cpu"),
                           overrides=SERVE)
    assert res["correct"], res["checks"]
    new = _new(name)
    assert len(new) == (5 if suffix == "serve" else 4)
    got = {m: res["metrics"][m]["value"] for m in new}
    for m in (f"step_launch_ms.{suffix}", f"step_gap_ms.{suffix}",
              f"admit_ms.{suffix}"):
        assert got[m] > 0
    if suffix == "serve":
        assert 0 < got["prefill_useful.serve"] <= 100
    # the harness's decode spans name each step's active slots and their
    # cached tokens, read from the engine's state at the call: the share
    # of the gather they give, over the steps the stretch holds whole
    tr = traces[-1]
    eng = SERVE["cell"]["engine"]
    gathered = eng["max_num_seqs"] * eng["max_model_len"]
    cached = [int(s[2].rsplit(".", 1)[1]) for s in tr.spans
              if s[2].startswith("portbench.decode.")
              and s[0] >= tr.t0 and s[1] <= tr.t1]
    assert cached
    want = 100.0 * sum(cached) / (len(cached) * gathered)
    assert got[f"decode_useful.{suffix}"] == pytest.approx(want, abs=2.0)
    m = progspans.mapped(tr)
    assert m.pairs > 0 and m.profiled
    split = m.split()
    assert split.get("not covered", 0.0) <= 0.1 * split["idle_s"]


def test_train_device_time_per_span(tmp_path):
    """The train step's own annotations in a profile of three steps (the
    driver's traced run opens its stretch by the clock, which a busy CPU
    can leave without a whole step)."""
    import port as P
    import weights as W
    from ray_tpu_torch.models.llama import make_train_step

    mc = {**harness.load_json("configs", "yi-6b.8L.json"), **TRAIN["config"]}
    cfg = P.llama_config(mc, torch.float32, attention_impl="flash",
                         max_seq_len=32)
    init_state, shard_state, train_step, _ = make_train_step(
        cfg, device=torch.device("cpu"))
    state = shard_state(init_state(W.draw(mc, SEED, torch.device("cpu"),
                                          torch.float32)))
    tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(SEED))
    prof = devtrace.Profile(str(tmp_path / "trace.json"))
    prof.open()
    for _ in range(3):
        state, _ = train_step(state, tokens)
    prof.stop()
    tr = devtrace.Trace(prof.path)
    # a CPU trace has no kernels; put one of a known length inside each
    # span, launched from inside it
    want = {}
    for k, name in enumerate(("train.forward", "train.backward")):
        spans = [s for s in tr.spans if s[2] == name]
        assert len(spans) == 3, name
        for i, (ts, end, _) in enumerate(spans):
            corr = 10**9 + 1000 * k + i
            tr.launch[corr] = (ts + end) / 2
            tr.kernels.append((ts + 1.0, ts + 1.0 + 100.0 * (k + 1), "fake",
                               corr))
        want[name] = 0.1 * (k + 1)
    tr.kernels.sort()
    ctx = {"trace": tr}
    fwd = harness.load_module("metrics", "fwd_ms.train").read(ctx)
    bwd = harness.load_module("metrics", "bwd_ms.train").read(ctx)
    assert fwd == pytest.approx(want["train.forward"])
    assert bwd == pytest.approx(want["train.backward"])
    assert set(_new("yi6b.train.s1024")) == {"fwd_ms.train", "bwd_ms.train"}


def test_readers_find_nothing_without_the_buffer(monkeypatch, traces):
    """A program that keeps no spans (the parent of this change) maps
    nothing: every reader returns None and none raises."""
    monkeypatch.setattr(progspans, "buffered", lambda: [])
    res = harness.run_cell("mistral7b.chat.long", SEED, 1.5, True,
                           torch.device("cpu"), overrides=SERVE)
    assert res["correct"]
    assert not set(_new("mistral7b.chat.long")) & set(res["metrics"])
