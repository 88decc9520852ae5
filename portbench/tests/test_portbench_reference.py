"""The plain reference against the port on a tiny model, both in float32 on
the CPU: the forward's logits, and three AdamW steps' losses, first
gradients and changes. The reference itself imports nothing of the port."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, TINY

import weights as W
from reference.llama import Reference

MC = {**json.load(open(os.path.join(BENCH, "configs", "mistral-7b-v0.3.json"))),
      **TINY}
HP = {"learning_rate": 1e-2, "betas": [0.9, 0.999], "eps": 1e-8,
      "weight_decay": 1e-4, "remat": False}


def _port_cfg(dtype):
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=128, rope_theta=1e6,
                       norm_eps=1e-5, max_seq_len=64, dtype=dtype,
                       param_dtype=torch.float32)


def test_reference_logits_match_the_port_forward():
    from ray_tpu_torch.models.llama import forward

    params = W.draw(MC, 11, "cpu", torch.float32)
    tokens = torch.randint(0, 256, (1, 40), generator=torch.Generator().manual_seed(0))
    want = forward(_port_cfg(torch.float32), params, tokens)[0]
    got = Reference(MC).logits_rows(params, tokens[0].tolist(), range(40))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_reference_training_matches_the_port_step():
    from ray_tpu_torch.models.llama import make_train_step

    params = W.draw(MC, 12, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, 256, (4, 33), generator=gen) for _ in range(3)]
    init_state, _, train_step, _ = make_train_step(
        _port_cfg(torch.float32), learning_rate=HP["learning_rate"],
        loss_chunk=0, device="cpu")
    state = init_state(params)
    sample = {n: torch.arange(0, t.numel(), 7) for n, t in W.leaves(params).items()}
    losses = []
    for k, b in enumerate(batches):
        state, loss = train_step(state, b)
        losses.append(float(loss))
        if k == 0:
            opt = state[1]
            g1 = {n: opt.state[p]["exp_avg"] / 0.1
                  for n, p in W.leaves(state[0]).items()}
    ref = Reference(MC).train(params, batches, HP, sample)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for n, g in ref["grad_norms"].items():
        assert float(g1[n].norm()) == pytest.approx(g, rel=1e-4), n
        torch.testing.assert_close(g1[n].reshape(-1)[sample[n]],
                                   ref["grad_sample"][n], rtol=1e-3, atol=1e-6)
    start = W.leaves(params)
    for n, p in W.leaves(state[0]).items():
        assert float((p.detach() - start[n]).norm()) == pytest.approx(
            ref["change_norms"][n], rel=1e-3, abs=1e-6), n


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference.llama, "
            "weights, yardstick, traffic; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ray_tpu_torch', 'ray_tpu', 'jax', 'jaxlib', 'flax'}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH).stdout.strip()
    assert out == "[]"


def test_fp8_control_rounds_products():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(2))
    exact = Reference(MC).mm(x, x)
    low = Reference(MC, "fp8").mm(x, x)
    err = float((low - exact).norm() / exact.norm())
    assert 1e-2 < err < 1e-1    # e4m3's 3 mantissa bits, not bf16's 8
