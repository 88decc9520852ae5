"""The frozen arithmetic against values worked out by hand."""

import json
import os

import pytest

import yardstick as Y

HERE = os.path.dirname(os.path.abspath(__file__))


def _cfg(name):
    with open(os.path.join(os.path.dirname(HERE), "configs", f"{name}.json")) as f:
        return json.load(f)


def test_mistral_parameters_and_kv_bytes():
    mc = _cfg("mistral-7b-v0.3")
    # a layer: wq, wo 4096x4096; wk, wv 4096x1024; 3 x 4096x14336
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    assert Y.matmul_params(mc) == 32 * layer + 4096 * 32768
    # with the embedding: Mistral-7B's published 7.25B
    assert round((Y.matmul_params(mc) + 32768 * 4096) / 1e9, 2) == 7.25
    assert Y.kv_bytes_per_token(mc) == 32 * 2 * 8 * 128 * 2 == 131072
    assert Y.weight_bytes(mc) == (Y.matmul_params(mc) + 65 * 4096) * 2


def test_decode_least_bytes():
    mc = _cfg("mistral-7b-v0.3")
    got = Y.decode_least_bytes(mc, active=2, cached=1000)
    assert got == Y.weight_bytes(mc) + 1000 * 131072 + 2 * (131072 + 8192)


def test_train_flops_per_token():
    mc = _cfg("yi-6b.8L")
    layer = 2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008
    n = 8 * layer + 4096 * 64000
    assert Y.train_flops_per_token(mc, 4096) == 6 * n + 12 * 8 * 4096 * 4096
    assert Y.train_flops_per_token(mc, 4096) == pytest.approx(11.488e9, rel=1e-3)


def test_forward_flops_counts_each_query_key_pair():
    mc = _cfg("mistral-7b-v0.3")
    n = Y.matmul_params(mc)
    # a 3-token prompt: pairs 1 + 2 + 3; then one token at position 3: 4 keys
    assert Y.forward_flops(mc, 0, 3) == 2 * n * 3 + 4 * 32 * 4096 * 6
    assert Y.forward_flops(mc, 3, 1) == 2 * n + 4 * 32 * 4096 * 4
    assert Y.forward_flops(mc, 0, 4) == Y.forward_flops(mc, 0, 3) + \
        Y.forward_flops(mc, 3, 1)


def test_k1_and_k23_costs():
    # b1 h2 kvh1 s4 hd8 causal: 10 pairs
    flops, nbytes = Y.k1_cost(1, 2, 1, 4, 8, True)
    assert flops == 4 * 2 * 8 * 10
    assert nbytes == 2 * (2 * 2 * 4 * 8 + 2 * 1 * 4 * 8) + 4 * 2 * 4
    c = Y.k23_cost(1, 2, 1, 4, 8, True)
    q, kv, rows = 2 * 2 * 4 * 8, 2 * 1 * 4 * 8, 4 * 2 * 4
    read = 2 * q + 2 * kv + 2 * rows
    assert c["k2"] == (2 * 3 * 2 * 8 * 10, read + 2 * q)
    assert c["k3"] == (2 * 4 * 2 * 8 * 10, read + 2 * kv)
    # the training shape is bound by operations
    f, b = Y.k1_cost(4, 32, 4, 4096, 128, True)
    assert Y.bound_s(f, b) == f / Y.PEAK_BF16_FLOPS


def test_percentile_and_spread():
    xs = list(range(1, 101))
    assert Y.percentile(xs, 95) == 95
    assert Y.percentile([5.0], 95) == 5.0
    assert Y.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)
