"""Parity of the PyTorch port's expert-parallel MoE
(``ray_tpu_torch.parallel.moe``) with the JAX package's.

``tests/test_moe.py``'s five tests against the port, each also held to
JAX on the same numpy inputs: ``_route``'s dispatch exactly, its combine
and aux within 1e-6; ``moe_ffn`` within 2e-5 abs / 2e-4 rel; and
``moe_ffn_ep`` over tp 4 with tokens over dp 2 and dp 1, its outputs, aux
and the gradients of mean(y²) against JAX's expert-parallel and
single-shard results. The port runs in a spawned child (``_port_proc``)
leading 8 gloo rank processes (``_port_ranks``); the dp 1 x tp 4 mesh is
laid over them as fsdp 2 x tp 4, so two copies of it run side by side
(nothing splits the tokens over fsdp). JAX runs on the 8-device CPU
mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from _port_proc import spawn
from ray_tpu.parallel.moe import _route, init_moe_params, moe_ffn, moe_ffn_ep

D_MODEL, D_FF, EXPERTS = 16, 32, 8
WORLD = 8
CALL_TIMEOUT_S = 120
# moe_ffn against JAX's: fp32, a different summation order
ATOL, RTOL = 2e-5, 2e-4


@pytest.fixture(scope="module")
def port():
    with spawn(timeout=CALL_TIMEOUT_S) as call:
        call("sp_start", WORLD)
        yield call
        call("sp_stop")


@pytest.fixture(scope="module")
def params():
    jp = init_moe_params(jax.random.PRNGKey(0), D_MODEL, D_FF, EXPERTS)
    return jp, jax.tree.map(np.asarray, jp)


def _x(key, n):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key),
                                        (n, D_MODEL)))


def test_single_shard_shapes_and_routing(port, params):
    """y of x's shape, finite; aux between 0.5 and E; both as JAX's."""
    jp, tree = params
    x = _x(1, 64)
    y, aux = port("moe_single", tree, x, 2, 2.0)
    assert y.shape == x.shape and np.isfinite(y).all()
    assert 0.5 < aux < float(EXPERTS)
    want_y, want_aux = moe_ffn(jp, jnp.asarray(x), top_k=2,
                               capacity_factor=2.0)
    np.testing.assert_allclose(y, np.asarray(want_y), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, float(want_aux), rtol=0, atol=1e-6)


def test_tokens_reach_topk_experts(port, params):
    """With capacity for every slot each token reaches its top-k experts:
    combine weights sum to ~1 and dispatch slots to 2 per token; dispatch
    equals JAX's exactly, combine and aux within 1e-6."""
    jp, tree = params
    logits = _x(2, 32) @ np.asarray(jp["router"])
    dispatch, combine, aux = port("moe_route", logits, 2, 32)
    np.testing.assert_allclose(combine.sum(axis=(1, 2)), 1.0, atol=1e-5)
    np.testing.assert_allclose(dispatch.sum(axis=(1, 2)), 2.0, atol=1e-6)
    want = _route(jnp.asarray(logits), 2, capacity=32)
    np.testing.assert_array_equal(dispatch, np.asarray(want[0]))
    np.testing.assert_allclose(combine, np.asarray(want[1]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(aux, float(want[2]), rtol=0, atol=1e-6)


def test_capacity_drops_overflow(port):
    """Every token prefers expert 0: 4 of 16 fit its capacity of 4, the
    first four in token order, as JAX places them."""
    logits = np.tile(np.array([[10.0] + [0.0] * (EXPERTS - 1)],
                              np.float32), (16, 1))
    dispatch, _, _ = port("moe_route", logits, 1, 4)
    assert float(dispatch.sum()) == pytest.approx(4.0)
    np.testing.assert_array_equal(
        dispatch, np.asarray(_route(jnp.asarray(logits), 1, capacity=4)[0]))


def _jax_ep(jp, x, dp, capacity_factor):
    """JAX's ``moe_ffn_ep`` on a (dp, 4) mesh: y, aux and the gradients of
    mean(y²)."""
    mesh = Mesh(np.array(jax.devices()[:4 * dp]).reshape(dp, 4), ("dp", "tp"))

    def run(p):
        return moe_ffn_ep(p, jnp.asarray(x), mesh=mesh, axis="tp",
                          tokens_spec=P("dp"), top_k=2,
                          capacity_factor=capacity_factor)

    y, aux = jax.jit(run)(jp)
    grads = jax.jit(jax.grad(lambda p: (run(p)[0] ** 2).mean()))(jp)
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("dp", [2, 1])
def test_ep_matches_single_shard(port, params, dp):
    """Expert parallel over tp 4, tokens over dp 2 (and dp 1), with a
    generous capacity (no drops): each rank's y block equals the single
    shard's and JAX's ep rows, aux JAX's ep aux (the mean of the dp
    shards' aux, near the single shard's); the router, w_in and w_out
    gradients of mean(y²), summed over dp and gathered, equal JAX's ep and
    single-shard gradients (and the port's single shard)."""
    jp, tree = params
    x = _x(4, 64)
    want_y, want_aux, want_grads = _jax_ep(jp, x, dp, 8.0)
    def single(p):
        return moe_ffn(p, jnp.asarray(x), top_k=2, capacity_factor=8.0)[0]

    single_y = jax.jit(single)(jp)
    single_grads = jax.jit(jax.grad(lambda p: (single(p) ** 2).mean()))(jp)
    np.testing.assert_allclose(want_y, np.asarray(single_y), rtol=RTOL,
                               atol=ATOL)
    results = port("sp_call", "moe_ep", tree, x, dp, 2 // dp, 4, 2, 8.0)
    seen = np.zeros(len(x), int)
    for y, r0, aux, _ in results:
        rows = len(x) // dp
        assert y.shape == (rows, D_MODEL)
        np.testing.assert_allclose(y, want_y[r0:r0 + rows], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(aux, want_aux, rtol=0, atol=1e-6)
        seen[r0:r0 + rows] += 1
    assert (seen == 4 * (2 // dp)).all()
    _, _, port_single = port("moe_single", tree, x, 2, 8.0, with_grads=True)
    grads = results[0][3]
    for k in ("router", "w_in", "w_out"):
        for want in (want_grads[k], np.asarray(single_grads[k]),
                     port_single[k]):
            np.testing.assert_allclose(grads[k], want, rtol=RTOL, atol=1e-6,
                                       err_msg=k)


def test_ep_grads_flow(port, params):
    """The ep path is differentiable end to end with the aux term in the
    loss: finite, nonzero gradients for every parameter."""
    _, tree = params
    x = _x(5, 32)
    results = port("sp_call", "moe_ep", tree, x, 1, 2, 4, 2, 4.0,
                   aux_weight=0.01)
    for k in ("router", "w_in", "w_out"):
        g = results[0][3][k]
        assert np.isfinite(g).all()
        assert np.abs(g).sum() > 0, f"zero grad for {k}"


def test_init_moe_params_defaults_to_cuda(port):
    """``init_moe_params`` with no device asks for CUDA: where there is
    none it raises naming it instead of running on the CPU."""
    got = port("vit_moe_cuda_default_errors")
    if got["cuda_available"]:
        pytest.skip("this machine has CUDA: the default device is valid")
    assert got["init_moe_params"] is not None
    assert "CUDA" in got["init_moe_params"]
