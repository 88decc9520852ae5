"""Parity of the PyTorch port's sequence-parallel model with the JAX package.

``MeshSpec`` against JAX's, and ``MeshSpec.build`` on a 4-rank gloo group
(one process a rank, ``_port_ranks``); then ``forward`` with every
``attention_impl`` on an sp 4 and a dp 2 x sp 2 mesh against JAX's
``forward(cfg, params, tokens, mesh)``, each rank's logits block against
its slice of JAX's global logits; ``loss_fn`` with a mesh; and
``make_train_step`` on dp 2 x sp 2 against JAX's on the same mesh shape, 3
AdamW steps from the same weights (carried by ``params_from_jax``) on the
same global batch.
All fp32 on the CPU, with 8 query and 4 kv heads so that Ulysses can split
them over sp 4. The port runs in a spawned child (``_port_proc``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_proc import spawn
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import AXES, MeshSpec

WORLD = 4
SHAPE = dict(vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
             ffn_dim=256, max_seq_len=256)
STEPS, LR = 3, 1e-2
# test_torch_train.py's leaf tolerance: AdamW's eps turns summation-order
# rounding of ~1e-8 gradients into ~1e-4 drift on a few elements
PARAM_ATOL = 1e-4
PARAM_OUTLIER_FRAC = 1e-3


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        call("sp_start", WORLD)
        yield call
        call("sp_stop")


@pytest.fixture(scope="module")
def weights():
    jp = jl.init_params(_jcfg(), jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _jcfg(**kw):
    return jl.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                          **SHAPE, **kw)


def _tokens(b, s, seed):
    return np.random.RandomState(seed).randint(
        0, SHAPE["vocab_size"], size=(b, s)).astype(np.int32)


def test_mesh_spec_matches_jax(port):
    got = port("mesh_spec_facts")
    for name, kw in (("default", {}), ("dp2sp2", dict(dp=2, sp=2)),
                     ("all", dict(dp=2, fsdp=2, tp=2, sp=2, pp=2))):
        spec = MeshSpec(**kw)
        assert got[name] == (spec.shape, spec.num_devices), name
    assert got["for_devices"] == MeshSpec.for_devices(8, tp=2).shape


def test_mesh_build_places_ranks_as_jax_places_devices(port):
    """``MeshSpec(dp=2, sp=2).build()`` over 4 gloo ranks: JAX's axis
    names, and rank r at the mesh position where JAX puts device r."""
    jmesh = MeshSpec(dp=2, sp=2).build(jax.devices()[:WORLD])
    facts = port("sp_call", "mesh_facts", 2, 2)
    for f in facts:
        assert f["names"] == AXES
        assert f["shape"] == dict(jmesh.shape)
        pos = np.argwhere(np.vectorize(lambda d: d.id)(jmesh.devices)
                          == f["rank"])[0]
        assert (f["index"]["dp"], f["index"]["sp"]) == (pos[1], pos[4])
        # the sp group: the ranks that share this rank's dp position
        assert f["sp_ranks"] == [f["rank"] - f["index"]["sp"] + j
                                 for j in range(2)]


@pytest.mark.parametrize("impl,dp,sp", [("ring", 1, 4), ("ulysses", 1, 4),
                                        ("ring", 2, 2)])
def test_forward_on_a_mesh_matches_jax(port, weights, impl, dp, sp):
    """Each rank's (b/dp, s/sp) block of the logits against its slice of
    JAX's ``forward`` on the same mesh shape (global tokens)."""
    _check_forward_blocks(port, weights, impl, dp, sp)


def _check_forward_blocks(port, weights, impl, dp, sp):
    jp, tree = weights
    toks = _tokens(2, 32, seed=dp + sp)
    mesh = MeshSpec(dp=dp, sp=sp).build(jax.devices()[:WORLD])
    cfg = _jcfg(attention_impl=impl)
    want = np.asarray(jax.jit(lambda p, t: jl.forward(cfg, p, t, mesh))(
        jp, jnp.asarray(toks)))
    blocks = port("sp_call", "forward", SHAPE, tree, toks, impl, dp, sp)
    seen = np.zeros(toks.shape, bool)
    for logits, r0, c0 in blocks:
        rows, cols = logits.shape[:2]
        assert (rows, cols) == (2 // dp, 32 // sp)
        np.testing.assert_allclose(
            logits, want[r0:r0 + rows, c0:c0 + cols], rtol=3e-4, atol=3e-4)
        seen[r0:r0 + rows, c0:c0 + cols] = True
    assert seen.all()  # the blocks tile the global logits


@pytest.mark.parametrize("impl,dp,sp", [("xla", 1, 4), ("flash", 1, 4),
                                        ("xla", 2, 2), ("flash", 2, 2)])
def test_plain_attention_on_a_sequence_sharded_mesh_matches_jax(
        port, weights, impl, dp, sp):
    """"xla" and "flash" on sp > 1: JAX's GSPMD all-gathers K and V and
    every query attends to the whole sequence; the port all-gathers K and
    V over the sp group and offsets the causal mask to the rank's block.
    Each rank's logits block against its slice of JAX's."""
    _check_forward_blocks(port, weights, impl, dp, sp)


@pytest.mark.parametrize("impl,dp,sp", [("xla", None, None), ("xla", 1, 4),
                                        ("flash", 2, 2), ("ring", 2, 2)])
def test_loss_fn_on_a_mesh_matches_jax(port, weights, impl, dp, sp):
    """``loss_fn(cfg, params, tokens, mesh)`` against JAX's on the same
    mesh shape (and with no mesh): every rank returns the global loss."""
    _check_loss(port, weights, impl, dp, sp, seq=33)  # 32 with a target


@pytest.mark.parametrize("impl,dp,sp", [("xla", 1, 4), ("flash", 1, 4),
                                        ("xla", 2, 2), ("flash", 2, 2)])
def test_loss_fn_on_a_mesh_at_an_even_length_matches_jax(port, weights, impl,
                                                         dp, sp):
    """As above at 32 tokens: the 31 positions with a target do not divide
    by sp. JAX's sharding takes the uneven blocks; the port pads the last
    block and masks its padding out of the loss."""
    _check_loss(port, weights, impl, dp, sp, seq=32)


def _check_loss(port, weights, impl, dp, sp, seq):
    jp, tree = weights
    toks = _tokens(2, seq, seed=7)
    mesh = None if dp is None else MeshSpec(dp=dp, sp=sp).build(
        jax.devices()[:WORLD])
    cfg = _jcfg(attention_impl=impl)
    want = float(jax.jit(lambda p, t: jl.loss_fn(cfg, p, t, mesh))(
        jp, jnp.asarray(toks)))
    for got in port("sp_call", "loss", SHAPE, tree, toks, impl, dp, sp):
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("impl,remat", [("ring", False), ("ring", "dots"),
                                        ("ulysses", False), ("xla", False),
                                        ("flash", False)])
def test_train_step_on_dp2_sp2_matches_jax(port, weights, impl, remat):
    """3 AdamW steps on the dp 2 x sp 2 mesh: the global loss of each step
    and the parameters after them against JAX's ``make_train_step`` on the
    same mesh shape; every rank reports the same losses."""
    jp, tree = weights
    toks = _tokens(4, 32, seed=5)
    mesh = MeshSpec(dp=2, sp=2).build(jax.devices()[:WORLD])
    init_state, shard_state, train_step, data_sharding = jl.make_train_step(
        _jcfg(attention_impl=impl), mesh, learning_rate=LR, remat=remat,
        loss_chunk=0)
    state = shard_state((jax.tree.map(jnp.asarray, tree),
                         init_state(jax.random.key(0))[1]))
    t = jax.device_put(jnp.asarray(toks), data_sharding)
    want = []
    for _ in range(STEPS):
        state, loss = train_step(state, t)
        want.append(float(loss))
    results = port("sp_call", "train", SHAPE, tree, toks, impl, remat, 0,
                   STEPS, LR, 2, 2)
    for losses, _, launches in results:
        np.testing.assert_allclose(losses, want, rtol=1e-4)
        assert launches == (0, 0, 0, 0)  # the CPU path runs no kernel
    assert want[-1] < want[0]
    got_params = results[0][1]
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
