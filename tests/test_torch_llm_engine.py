"""Parity of the PyTorch port's serving path with the JAX package on CPU:
greedy tokens of the paged engine, the dense generator and the LLMServer
equal the JAX package's with the same weights (carried across by
``params_from_jax``), the prefix cache and abort sweep keep their block
accounting, and the port imports neither JAX nor ``ray_tpu``. The port
runs in a spawned child (``_port_proc``)."""

import asyncio
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_proc import spawn
from ray_tpu.llm import LLMConfig as JLLMConfig
from ray_tpu.llm import LLMServer as JLLMServer
from ray_tpu.llm._engine import EngineConfig as JEngineConfig
from ray_tpu.llm._engine import PagedEngine as JPagedEngine
from ray_tpu.llm._generate import generate as jgenerate
from ray_tpu.models import llama as jl

SHAPE = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=128, max_seq_len=256)
JCFG = jl.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, **SHAPE)


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        yield call


@pytest.fixture(scope="module")
def weights():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _jax_engine(weights, **ecfg):
    return JPagedEngine(JCFG, weights[0], JEngineConfig(**ecfg))


def _gen_all(eng, prompts, max_tokens=8):
    async def one(p):
        return [t async for t in eng.generate_stream(
            p, max_tokens=max_tokens, temperature=0.0)]

    async def main():
        return await asyncio.gather(*[one(p) for p in prompts])

    return asyncio.run(main())


def test_paged_matches_jax_engine_and_dense_decode(port, weights):
    prompts = [[1, 5, 9], [3, 3, 3, 7, 2], [42]]
    ecfg = dict(max_num_seqs=3, kv_block_size=4, num_kv_blocks=32,
                max_model_len=64)
    [(got, st)] = port("engine_generate", SHAPE, weights[1], ecfg, prompts)
    assert got == _gen_all(_jax_engine(weights, **ecfg), prompts)
    assert got == port("dense_generate", SHAPE, weights[1], prompts, 8)
    assert st["free_blocks"] == 32
    assert port("launches") == 0  # the CPU path runs the plain K1


def test_block_reuse_across_waves_matches_jax(port, weights):
    """More sequences over time than the pool could ever hold at once."""
    prompts = [[i % 100 + 1, i % 50] for i in range(10)]
    ecfg = dict(max_num_seqs=2, kv_block_size=4, num_kv_blocks=8,
                max_model_len=24, prefix_cache=False)
    [(got, st)] = port("engine_generate", SHAPE, weights[1], ecfg, prompts,
                       max_tokens=6)
    assert len(got) == 10 and all(len(o) == 6 for o in got)
    assert got == _gen_all(_jax_engine(weights, **ecfg), prompts,
                           max_tokens=6)
    assert st["free_blocks"] == 8


def test_mid_decode_admission_matches_jax(port, weights):
    first_prompt = [7, 1, 4, 4, 9, 2]
    later = [[11, 12], [30, 31, 32, 33, 34], [5]]
    ecfg = dict(max_num_seqs=4, kv_block_size=8, num_kv_blocks=64,
                max_model_len=96)
    got, st = port("engine_mid_decode", SHAPE, weights[1], ecfg,
                   first_prompt, later)
    assert st["mid_decode_admissions"] >= 1
    assert st["blocks_in_use"] == 0 and st["active_slots"] == 0
    assert st["tokens_out"] == 20 + 3 * 8
    want = _gen_all(_jax_engine(weights, **ecfg), [first_prompt],
                    max_tokens=20) + _gen_all(
        _jax_engine(weights, **ecfg), later)
    assert got == want


def test_disaggregated_prefill_matches_local(port, weights):
    """KV prefilled in another pool and injected into the decode engine
    gives the locally prefilled request's tokens."""
    ecfg = dict(max_num_seqs=2, kv_block_size=4, num_kv_blocks=32,
                max_model_len=64)
    local, disagg, st = port("engine_disaggregated", SHAPE, weights[1], ecfg,
                             [[1, 5, 9, 2, 8], [7, 7, 3]])
    assert disagg == local
    assert st["free_blocks"] == 32


def test_prefix_cache_warm_matches_cold_and_jax(port, weights):
    """A prompt served from cached prefix blocks (suffix prefill) gives the
    cold tokens, which are the JAX engine's."""
    prompt = np.random.RandomState(0).randint(1, 500, size=80).tolist()
    prompt += [7, 8]
    ecfg = dict(max_num_seqs=2, kv_block_size=16, num_kv_blocks=32,
                max_model_len=256, prefix_cache=True)
    (cold, st0), (warm, st1) = port("engine_generate", SHAPE, weights[1],
                                    ecfg, [prompt], repeat=2)
    assert warm == cold
    assert st1["prefix_cache"]["block_hits"] > st0["prefix_cache"][
        "block_hits"]
    assert cold == _gen_all(_jax_engine(weights, **ecfg), [prompt])
    assert st1["free_blocks"] == 32 and st1["blocks_in_use"] == 0


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_aborted_streams_leak_no_blocks(port, weights, prefix_cache):
    """Clients take one token and walk away: the abort sweep returns every
    KV block (with the cache on, as evictable capacity)."""
    ecfg = dict(max_num_seqs=2, kv_block_size=16, num_kv_blocks=32,
                max_model_len=256, prefix_cache=prefix_cache)
    prefix = np.random.RandomState(2).randint(1, 500, size=48).tolist()
    st = port("engine_aborts", SHAPE, weights[1], ecfg, prefix)
    assert st["blocks_in_use"] == 0 and st["active_slots"] == 0
    assert st["free_blocks"] == 32
    if prefix_cache:
        assert st["prefix_cache"]["block_hits"] > 0


def test_generate_matches_jax_and_full_forward(port, weights):
    jp, tree = weights
    prompts = [[1, 5, 9, 2, 7], [3, 3], [200, 100, 50]]
    got = port("dense_generate", SHAPE, tree, prompts, 6)
    assert got == jgenerate(JCFG, jp, prompts, max_new_tokens=6,
                            temperature=0.0)
    # KV-cache decoding equals recompute-from-scratch greedy decoding
    for p, out in zip(prompts, got):
        assert out == port("naive_greedy", SHAPE, tree, p, 6), p
    # the streaming generator yields the same tokens
    assert port("stream_generate", SHAPE, tree, prompts[0], 6) == got[0]
    # temperature sampling is seeded: same seed, same tokens
    a = port("dense_generate", SHAPE, tree, [[7, 8, 9]], 4,
             temperature=0.8, seed=3)
    assert len(a[0]) == 4
    assert a == port("dense_generate", SHAPE, tree, [[7, 8, 9]], 4,
                     temperature=0.8, seed=3)


def test_llm_server_text_matches_jax(port, tmp_path):
    jp = jl.init_params(jl.LlamaConfig.tiny(dtype=jnp.float32),
                        jax.random.PRNGKey(1))
    path = str(tmp_path / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jp), f)
    jserver = JLLMServer(JLLMConfig(
        max_new_tokens=6, checkpoint_path=path,
        model_overrides=dict(dtype=jnp.float32)))
    batch = {"prompt": ["hello", "a b"], "max_tokens": 6}
    stream = {"prompt": "hello", "max_tokens": 6, "stream": True}
    got, chunks = port("llm_server", path, 6, batch, stream)
    want = jserver(batch)
    assert [c["text"] for c in got["choices"]] == [
        c["text"] for c in want["choices"]]
    assert got["usage"]["completion_tokens"] == \
        want["usage"]["completion_tokens"]
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        "".join(c["choices"][0]["text"] for c in jserver(stream))
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_port_imports_neither_jax_nor_ray_tpu(port):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc, out, err = port("import_check", root)
    assert rc == 0, err


def test_entry_points_raise_without_cuda(port, weights):
    got = port("cuda_default_errors", SHAPE, weights[1])
    if got["cuda_available"]:
        pytest.skip("this machine has CUDA: the default device is valid")
    for name in ("PagedEngine", "LLMServer", "build_model"):
        assert got[name] is not None and "CUDA" in got[name], name
