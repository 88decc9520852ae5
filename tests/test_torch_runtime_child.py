"""The parts of the port's runtime that handle tensors, in the torch child
(``_port_proc``): torch tensors through the object plane (serialize /
deserialize, then a cluster of the port on the CPU), and the engine's
gauges on the port's metrics plane against the JAX engine's."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_proc import spawn
from ray_tpu.llm._engine import EngineConfig as JEngineConfig
from ray_tpu.llm._engine import PagedEngine as JPagedEngine
from ray_tpu.models import llama as jl
from ray_tpu.util.metrics import reset_registry, snapshot_all

SHAPE = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=128, max_seq_len=256)
JCFG = jl.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, **SHAPE)
CASES = ["bf16", "fp32_transposed", "int64_scalar", "bool", "empty",
         "requires_grad", "large_bf16"]


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        yield call


@pytest.fixture(scope="module")
def roundtrips(port):
    return port("tensor_roundtrip"), port("tensor_cluster_roundtrip")


@pytest.mark.parametrize("case", CASES)
def test_tensor_through_the_object_plane(roundtrips, case):
    """A tensor comes back equal (dtype, shape, device, requires_grad,
    values), its bytes one out-of-band buffer beside the numpy array's;
    through a cluster both ways."""
    local, cluster = roundtrips
    same, buffers = local[case]
    assert same and buffers == 2
    assert cluster[case] == (True, True)


def _jax_gauges(ecfg, prompts, max_tokens, weights):
    reset_registry()
    eng = JPagedEngine(JCFG, weights, JEngineConfig(**ecfg))

    def gauges():
        return sorted((s["name"], s["value"]) for s in snapshot_all()
                      if s["name"].startswith("rt_llm_")
                      and s["type"] == "gauge")

    async def main():
        gens = [eng.generate_stream(p, max_tokens=max_tokens,
                                    temperature=0.0) for p in prompts]
        for g in gens:
            await g.__anext__()
        mid = gauges()
        for g in gens:
            async for _ in g:
                pass
        return mid, gauges()

    return asyncio.run(main())


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_engine_gauges_match_jax(port, prefix_cache):
    """``PagedEngine._publish_metrics`` sets JAX's two gauges: with every
    request admitted and after all finished, the port's registry holds the
    JAX engine's values."""
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    prompts = [[1, 5, 9, 2, 7], [3, 3, 3, 7, 2, 1, 5, 9, 2], [42]]
    ecfg = dict(max_num_seqs=4, kv_block_size=4, num_kv_blocks=64,
                max_model_len=96, prefix_cache=prefix_cache)
    want = _jax_gauges(ecfg, prompts, 40, jp)
    got = port("engine_metrics", SHAPE, jax.tree.map(np.asarray, jp), ecfg,
               prompts, 40)
    assert [list(map(tuple, g)) for g in got] == [list(g) for g in want]
    names = [n for n, _ in want[0]]
    assert names == ["rt_llm_batch_occupancy", "rt_llm_kv_blocks_in_use"]
    assert dict(want[0])["rt_llm_batch_occupancy"] == 0.75
    assert dict(want[1]) == {"rt_llm_batch_occupancy": 0.0,
                             "rt_llm_kv_blocks_in_use": 0}
