"""Both drivers end to end on the CPU at a tiny size: what a run prints,
the metrics each line carries, and that nothing of JAX or the JAX package
is loaded once a run has ended."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, SERVE, TRAIN

import run as harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name,over", [("mistral7b.chat.short", SERVE),
                                       ("mistral7b.chat.long", SERVE),
                                       ("yi6b.train.s4096", TRAIN)])
@pytest.mark.parametrize("traced", [False, True])
def test_dry_run(name, over, traced):
    res = harness.run_cell(name, 2**31 + 77, 1.5, traced, torch.device("cpu"),
                           overrides=over)
    assert res["correct"], res["checks"]
    assert list(res)[:5] == KEYS and list(res)[-2:] == ["checks", "_extra"]
    want = harness.cell_metrics(harness.load_bench(), name, traced)
    if traced:
        assert "busy_s" in res["device"] and "window_s" in res["device"]
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU trace has no kernels: device readers find nothing to read
        assert set(res["metrics"]) <= set(want)
    else:
        assert set(res["metrics"]) == set(want)
    for m in res["metrics"].values():
        assert m["value"] > 0 or m["unit"] == "%"


def test_report_puts_checks_last(capsys):
    res = harness.run_cell("yi6b.train.s1024", 5, 0.5, False,
                           torch.device("cpu"), overrides=TRAIN)
    harness.report(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS + ["checks"]
    assert err.strip().splitlines()[-1].startswith("check weights_redrawn_differ")


def test_same_seed_same_traffic_and_weights():
    import traffic as T
    import weights as W

    mix = T.load("chat.long")
    a = T.closed_loop_requests(mix, 2**33 + 1, 32768, 2048)
    b = T.closed_loop_requests(mix, 2**33 + 1, 32768, 2048)
    c = T.closed_loop_requests(mix, 2**33 + 2, 32768, 2048)
    assert [r.prompt for r in a] == [r.prompt for r in b]
    # another seed: other token ids, the same lengths in the same order
    assert [len(r.prompt) for r in a] == [len(r.prompt) for r in c]
    assert [r.max_tokens for r in a] == [r.max_tokens for r in c]
    assert [r.prompt for r in a] != [r.prompt for r in c]
    assert all(8 <= len(r.prompt) <= 1920 and r.max_tokens >= 1
               and len(r.prompt) + r.max_tokens <= 2048 for r in a)
    p1 = W.checksum(W.draw(SERVE["config"] | {"rope_theta": 1, "rms_norm_eps": 1},
                           9, "cpu", torch.float32))
    p2 = W.checksum(W.draw(SERVE["config"] | {"rope_theta": 1, "rms_norm_eps": 1},
                           9, "cpu", torch.float32))
    assert p1 == p2


def test_no_jax_after_a_run():
    code = f"""
import sys
sys.path.insert(0, {BENCH!r})
import torch, run
from conftest import SERVE, TRAIN
run.run_cell("mistral7b.chat.short", 3, 0.5, False, torch.device("cpu"), overrides=SERVE)
run.run_cell("yi6b.train.s1024", 3, 0.5, False, torch.device("cpu"), overrides=TRAIN)
print(run.banned_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=BENCH + "/tests", timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, f"{BENCH}/run.py", "--workload",
                          "yi6b.train.s1024", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
