"""Parity of the PyTorch port's ``make_train_step`` with the JAX package's on
`tiny` (fp32), from the same weights (carried by ``params_from_jax``) and the
same token batch: losses over 5 AdamW steps and the parameters after them,
for each attention implementation, remat mode and the chunked loss. JAX
runs on a one-device mesh (``test_torch_sequence_parallel.py`` holds the
dp x sp mesh). The port's AdamW is also held to
``optax.adamw`` on identical gradients. The port runs in a spawned child
(``_port_proc``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from _port_proc import spawn
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import MeshSpec

SHAPE = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=256, max_seq_len=256)  # LlamaConfig.tiny
STEPS, LR = 5, 1e-2
# AdamW divides each gradient by its running RMS + eps (1e-8): where a
# gradient is itself ~1e-8 (a near-cancelling sum), the summation-order
# rounding of the two frameworks (~1e-9) moves the update by ~1% of LR.
# Such elements are rare (the optimizer alone agrees to 1e-6 on identical
# gradients, below): at most PARAM_OUTLIER_FRAC of a leaf may lie beyond
# PARAM_ATOL.
PARAM_ATOL = 1e-4
PARAM_OUTLIER_FRAC = 1e-3


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        yield call


@pytest.fixture(scope="module")
def weights():
    jp = jl.init_params(jl.LlamaConfig(dtype=jnp.float32,
                                       param_dtype=jnp.float32, **SHAPE),
                        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("impl,remat,loss_chunk", [
    ("xla", False, 512),
    ("flash", False, 512),
    ("flash", "ffn", 512),
    ("flash", "dots", 512),
    ("flash", True, 512),
    ("flash", False, 8),  # s 32 in four checkpointed chunks
])
def test_train_step_matches_jax(port, weights, impl, remat, loss_chunk):
    cfg = jl.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                         attention_impl=impl, **SHAPE)
    tokens = np.random.RandomState(7).randint(
        0, SHAPE["vocab_size"], size=(2, 32)).astype(np.int32)
    mesh = MeshSpec().build(jax.devices()[:1])
    init_state, shard_state, train_step, data_sharding = jl.make_train_step(
        cfg, mesh, learning_rate=LR, remat=remat, loss_chunk=loss_chunk)
    params = jax.tree.map(jnp.asarray, weights)
    state = shard_state((params, init_state(jax.random.key(0))[1]))
    toks = jax.device_put(jnp.asarray(tokens), data_sharding)
    want = []
    for _ in range(STEPS):
        state, loss = train_step(state, toks)
        want.append(float(loss))
    got, got_params, launches = port("train", SHAPE, weights, tokens, impl,
                                     remat, loss_chunk, STEPS, LR)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    want_params = jax.tree.map(np.asarray, state[0])
    pairs = [(key, got_params[key], want_params[key])
             for key in ("tok_emb", "norm", "lm_head")] + [
        (key, got_params["layers"][key], w)
        for key, w in want_params["layers"].items()]
    assert len(pairs) == 12
    for key, g, w in pairs:
        diff = np.abs(g - w)
        assert np.mean(diff > PARAM_ATOL) <= PARAM_OUTLIER_FRAC, (
            key, np.sort(diff.ravel())[-5:])
        assert diff.max() <= LR * STEPS, (key, diff.max())
    assert launches == (0, 0, 0)  # the CPU path runs the plain versions


def test_adamw_matches_optax(port):
    """The port's AdamW against ``optax.adamw`` on identical gradients:
    betas, eps, bias correction and the 1e-4 weight decay on every leaf
    (torch's default is 1e-2). Some gradients are near eps, where the
    normalisation is most sensitive."""
    rng = np.random.RandomState(3)
    params = [rng.randn(64, 32).astype(np.float32),
              np.ones(32, np.float32)]
    grads = [[(rng.randn(*p.shape) * rng.choice([1e-8, 1e-3, 1.0],
                                                 size=p.shape)
               ).astype(np.float32) for p in params] for _ in range(STEPS)]
    tx = optax.adamw(LR)
    want = [jnp.asarray(p) for p in params]
    opt_state = tx.init(want)
    for step in grads:
        updates, opt_state = tx.update([jnp.asarray(g) for g in step],
                                       opt_state, want)
        want = optax.apply_updates(want, updates)
    got = port("adamw_steps", params, grads, LR)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)


def test_train_step_takes_every_mesh(port):
    """``make_train_step`` accepts every mesh JAX's does: pp, which no spec
    names, is a replica axis there as in JAX (the pipeline schedule over
    it is ``parallel/pipeline.py``, ``test_torch_pipeline.py``); fsdp, tp
    and dp x fsdp x tp meshes (``test_torch_model_parallel.py``), dp x sp
    meshes (``test_torch_sequence_parallel.py``) and a mesh of one device
    as before. A pp mesh's results are held to JAX's in
    ``test_torch_model_parallel.py``."""
    for axes in ({}, {"pp": 2}, {"pp": 2, "tp": 2}, {"dp": 2}, {"sp": 4},
                 {"dp": 2, "sp": 2}, {"fsdp": 2}, {"tp": 2},
                 {"dp": 2, "fsdp": 2, "tp": 2}):
        assert port("train_step_mesh", SHAPE, axes) is None, axes
