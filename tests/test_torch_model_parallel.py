"""Parity of the PyTorch port's sharded model and training with the JAX
package on fsdp and tp meshes.

``param_specs`` and the data / activation specs against JAX's; each rank's
``shard_of`` block against the block JAX's ``NamedSharding`` puts on mesh
device r, and ``gather_full`` back; then ``forward`` on dp 2 x fsdp 2 x
tp 2, fsdp 4 x tp 2 and tp 2 x sp 4 (with sp's attention impls) against
JAX's sharded ``forward``, each rank's logits block against its slice of
JAX's; ``loss_fn`` on dp 2 x fsdp 2 x tp 2; and ``make_train_step`` there
against JAX's on the same mesh shape, 5 AdamW steps from the same weights
(``params_from_jax``) on the same global batch: the losses, the gathered
parameters and the first step's gathered gradients (a collective that sums
over tp, or sums a gradient twice over fsdp, doubles a gradient; AdamW's
normalisation hides that from the losses for a step or two). Last, meshes
whose axes do not divide what they split (3 kv heads over tp 2, ffn 250
and vocab 510 over tp 4, vocab 510 over fsdp 4, dim 100 over fsdp 8):
``forward`` and 3 steps against JAX's program on the same mesh shape.
And pp 2 x dp 2 x tp 2, where pp is a replica axis as in JAX: ``forward``
and 3 steps against JAX's.

All fp32 on the CPU, on ``tiny``'s widths with 8 query and 4 kv heads, so
that Ulysses can split them. The port runs in a spawned child
(``_port_proc``) leading 8 gloo rank processes (``_port_ranks``); JAX runs
on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from _port_proc import spawn
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import (MeshSpec, activation_spec, data_spec,
                                   logical_to_sharding)

WORLD = 8
SHAPE = dict(vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
             ffn_dim=256, max_seq_len=256)
STEPS, LR = 5, 1e-2
# test_torch_train.py's leaf tolerance: AdamW's eps turns summation-order
# rounding of ~1e-8 gradients into ~1e-4 drift on a few elements
PARAM_ATOL = 1e-4
PARAM_OUTLIER_FRAC = 1e-3
GRAD_ATOL = 1e-5
CALL_TIMEOUT_S = 120  # each call to the port's child, its 8 ranks' start too


@pytest.fixture(scope="module")
def port():
    with spawn(timeout=CALL_TIMEOUT_S) as call:
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


def _jmesh(dp=1, fsdp=1, tp=1, sp=1, pp=1):
    return MeshSpec(dp=dp, fsdp=fsdp, tp=tp, sp=sp, pp=pp).build(
        jax.devices()[:WORLD])


def _sharded(jp, cfg, mesh):
    return jax.tree.map(jax.device_put, jp,
                        logical_to_sharding(jl.param_specs(cfg), mesh))


def _tokens(b, s, seed):
    return np.random.RandomState(seed).randint(
        0, SHAPE["vocab_size"], size=(b, s)).astype(np.int32)


def test_param_specs_match_jax(port):
    """``param_specs`` leaf for leaf, and ``data_spec`` /
    ``activation_spec``."""
    want = jax.tree.map(tuple, jl.param_specs(_jcfg()),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    got = port("param_specs", SHAPE)
    assert got == want
    assert port("data_specs") == (tuple(data_spec()),
                                  tuple(activation_spec()))


@pytest.mark.parametrize("axes", [dict(dp=2, fsdp=2, tp=2),
                                  dict(tp=2, sp=4)])
def test_shard_of_is_the_block_jax_places_on_device_r(port, axes):
    """Each rank's ``shard_of`` block of global arrays under the data,
    activation and weight specs against the data of the
    ``addressable_shards`` that JAX's ``NamedSharding`` puts on mesh device
    r (rank r is at device r's mesh position); ``gather_full`` of the
    block gives the global array back. The last four arrays have dims
    their axes do not divide (blocks 2, 2, 2, 0 of 6 rows over dp x fsdp
    among them): JAX places no such array outside a program, and inside
    one GSPMD pads each such dim at its end to a multiple of its blocks,
    so device r's block is its block of the padded array less the
    padding."""
    mesh = _jmesh(**axes)
    rng = np.random.RandomState(3)
    specs = [data_spec(), activation_spec(), PartitionSpec(None, "fsdp", "tp"),
             PartitionSpec(None, "tp", "fsdp"), PartitionSpec("fsdp", "tp"),
             PartitionSpec(None), data_spec(),
             PartitionSpec(None, "fsdp", "tp"), PartitionSpec("fsdp", "tp"),
             activation_spec()]
    shapes = [(8, 16), (8, 16, 6), (3, 8, 12), (3, 12, 8), (8, 12), (12,),
              (6, 5), (3, 7, 5), (5, 9), (7, 6, 3)]
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    want = []
    for a, spec in zip(arrays, specs):
        blocks = [int(np.prod([mesh.shape[x] for x in
                               ((e,) if isinstance(e, str) else e or ())]))
                  for e in tuple(spec) + (None,) * (a.ndim - len(spec))]
        padded = np.pad(a, [(0, -n % k) for n, k in zip(a.shape, blocks)])
        placed = jax.device_put(padded, NamedSharding(mesh, spec))
        want.append({sh.device.id: a[sh.index] for sh in
                     placed.addressable_shards})
    got = port("sp_call", "shards", arrays, [tuple(s) for s in specs],
               axes.get("dp", 1), axes.get("fsdp", 1), axes.get("tp", 1),
               axes.get("sp", 1))
    for rank, blocks in enumerate(got):
        for i, (block, round_trip) in enumerate(blocks):
            np.testing.assert_array_equal(block, want[i][rank],
                                          err_msg=f"rank {rank} {specs[i]}")
            assert round_trip, (rank, specs[i])


@pytest.mark.parametrize("impl,axes", [
    ("xla", dict(dp=2, fsdp=2, tp=2)),
    ("flash", dict(dp=2, fsdp=2, tp=2)),
    ("xla", dict(fsdp=4, tp=2)),
    ("ring", dict(tp=2, sp=4)),
    ("ulysses", dict(tp=2, sp=4)),  # 2 kv heads a tp rank: heads gathered
    ("ulysses", dict(dp=2, tp=2, sp=2)),  # a tp rank's heads split over sp
    ("flash", dict(tp=2, sp=4)),
])
def test_forward_on_a_sharded_mesh_matches_jax(port, weights, impl, axes):
    """Each rank's (b/(dp·fsdp), s/sp) block of the logits, from its blocks
    of the weights, against its slice of JAX's ``forward`` on the same mesh
    shape from the same weights placed by ``param_specs``."""
    jp, tree = weights
    dp, fsdp = axes.get("dp", 1), axes.get("fsdp", 1)
    tp, sp = axes.get("tp", 1), axes.get("sp", 1)
    toks = _tokens(4, 32, seed=dp + 2 * fsdp + 3 * sp)
    mesh = _jmesh(**axes)
    cfg = _jcfg(attention_impl=impl)
    want = np.asarray(jax.jit(lambda p, t: jl.forward(cfg, p, t, mesh))(
        _sharded(jp, cfg, mesh), jnp.asarray(toks)))
    tol = 3e-4 if impl == "ring" else 2e-4
    blocks = port("sp_call", "forward", SHAPE, tree, toks, impl, dp, sp,
                  fsdp, tp)
    seen = np.zeros(toks.shape, int)
    for logits, r0, c0 in blocks:
        rows, cols = logits.shape[:2]
        assert (rows, cols) == (4 // (dp * fsdp), 32 // sp)
        np.testing.assert_allclose(
            logits, want[r0:r0 + rows, c0:c0 + cols], rtol=tol, atol=tol)
        seen[r0:r0 + rows, c0:c0 + cols] += 1
    assert (seen == tp).all()  # tp ranks share a block; the blocks tile


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_fn_on_dp2_fsdp2_tp2_matches_jax(port, weights, impl):
    """``loss_fn(cfg, params, tokens, mesh)`` from each rank's blocks
    against JAX's on the same mesh shape: every rank returns the global
    loss, summed over the data axes and not over tp."""
    jp, tree = weights
    toks = _tokens(4, 33, seed=7)
    mesh = _jmesh(dp=2, fsdp=2, tp=2)
    cfg = _jcfg(attention_impl=impl)
    want = float(jax.jit(lambda p, t: jl.loss_fn(cfg, p, t, mesh))(
        _sharded(jp, cfg, mesh), jnp.asarray(toks)))
    for got in port("sp_call", "loss", SHAPE, tree, toks, impl, 2, 1, 2, 2):
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("remat,loss_chunk", [(False, 0), ("dots", 0),
                                               ("dots", 8)])
def test_train_step_on_dp2_fsdp2_tp2_matches_jax(port, weights, remat,
                                                 loss_chunk):
    """5 AdamW steps on the dp 2 x fsdp 2 x tp 2 mesh ("flash"): the
    global loss of each step, the gathered parameters after them and the
    gathered gradients of the first step against JAX's ``make_train_step``
    and ``jax.grad`` of its loss on the same mesh shape; every rank reports
    the same losses. ``loss_chunk`` 8 cuts the loss into 4 chunks under
    checkpoint, lm_head gathered once for all of them."""
    jp, tree = weights
    toks = _tokens(8, 32, seed=5)
    mesh = _jmesh(dp=2, fsdp=2, tp=2)
    cfg = _jcfg(attention_impl="flash")
    params = _sharded(jp, cfg, mesh)
    t = jax.device_put(jnp.asarray(toks), NamedSharding(mesh, data_spec()))
    want_grads = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p, x: jl.loss_fn(cfg, p, x, mesh)))(params, t))
    init_state, shard_state, train_step, _ = jl.make_train_step(
        cfg, mesh, learning_rate=LR, remat=remat, loss_chunk=loss_chunk)
    state = shard_state((params, init_state(jax.random.key(0))[1]))
    want = []
    for _ in range(STEPS):
        state, loss = train_step(state, t)
        want.append(float(loss))
    results = port("sp_call", "train", SHAPE, tree, toks, "flash", remat,
                   loss_chunk, STEPS, LR, 2, 1, 2, 2, with_grads=True)
    for losses, _, launches, _ in results:
        np.testing.assert_allclose(losses, want, rtol=1e-4)
        assert launches == (0, 0, 0, 0)  # the CPU path runs no kernel
    assert want[-1] < want[0]
    got_params, got_grads = results[0][1], results[0][3]
    want_params = jax.tree.map(np.asarray, state[0])
    for key, g, w in _pairs(got_params, want_params):
        diff = np.abs(g - w)
        assert np.mean(diff > PARAM_ATOL) <= PARAM_OUTLIER_FRAC, (
            key, np.sort(diff.ravel())[-5:])
        assert diff.max() <= LR * STEPS, (key, diff.max())
    for key, g, w in _pairs(got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL,
                                   err_msg=key)


PP_STEPS = 3


def test_pp_mesh_is_a_replica_axis_as_in_jax(port, weights):
    """pp 2 x dp 2 x tp 2 ("flash"): pp, which no spec names, is a
    replica axis in JAX, each pp slice computing the whole model on the
    same data. Each rank's ``forward`` block against its slice of JAX's
    on the same mesh shape (both pp slices hold the same blocks), then 3
    ``make_train_step`` steps against JAX's: every rank's losses, the
    gathered parameters after them and the first step's gathered
    gradients (a gradient summed over pp would be doubled), at
    ``test_train_step_on_dp2_fsdp2_tp2_matches_jax``'s tolerances."""
    jp, tree = weights
    toks = _tokens(8, 32, seed=13)
    mesh = _jmesh(pp=2, dp=2, tp=2)
    cfg = _jcfg(attention_impl="flash")
    params = _sharded(jp, cfg, mesh)
    t = jax.device_put(jnp.asarray(toks), NamedSharding(mesh, data_spec()))
    want_logits = np.asarray(jax.jit(
        lambda p, x: jl.forward(cfg, p, x, mesh))(params, t))
    seen = np.zeros(toks.shape, int)
    for logits, r0, c0 in port("sp_call", "forward", SHAPE, tree, toks,
                               "flash", 2, 1, 1, 2, pp=2):
        assert logits.shape == (4, 32, SHAPE["vocab_size"])
        np.testing.assert_allclose(logits, want_logits[r0:r0 + 4],
                                   rtol=2e-4, atol=2e-4)
        seen[r0:r0 + 4] += 1
    assert (seen == 4).all()  # pp 2 x tp 2 ranks share each block
    want_grads = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p, x: jl.loss_fn(cfg, p, x, mesh)))(params, t))
    init_state, shard_state, train_step, _ = jl.make_train_step(
        cfg, mesh, learning_rate=LR, loss_chunk=0)
    state = shard_state((params, init_state(jax.random.key(0))[1]))
    want = []
    for _ in range(PP_STEPS):
        state, loss = train_step(state, t)
        want.append(float(loss))
    results = port("sp_call", "train", SHAPE, tree, toks, "flash", False, 0,
                   PP_STEPS, LR, 2, 1, 1, 2, with_grads=True, pp=2)
    for losses, _, launches, _ in results:
        np.testing.assert_allclose(losses, want, rtol=1e-4)
        assert launches == (0, 0, 0, 0)
    got_params, got_grads = results[0][1], results[0][3]
    for key, g, w in _pairs(got_params, jax.tree.map(np.asarray, state[0])):
        diff = np.abs(g - w)
        assert np.mean(diff > PARAM_ATOL) <= PARAM_OUTLIER_FRAC, (
            key, np.sort(diff.ravel())[-5:])
        assert diff.max() <= LR * PP_STEPS, (key, diff.max())
    for key, g, w in _pairs(got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL,
                                   err_msg=key)


def test_shard_state_places_a_global_state(port, weights):
    """``shard_state`` on a global (params, AdamW) state taken from one
    single-device step (JAX's ``shard_state`` places a global state the
    same way): every parameter and moment becomes the rank's block, the
    step count stays, and the next step's loss on dp 2 x fsdp 2 x tp 2
    equals the single-device next step's."""
    _, tree = weights
    toks = _tokens(8, 32, seed=9)
    for placed_ok, loss, want in port("sp_call", "shard_global_state", SHAPE,
                                      tree, toks, LR, 2, 1, 2, 2):
        assert placed_ok
        np.testing.assert_allclose(loss, want, rtol=1e-5)


def _pairs(got, want):
    pairs = [(key, got[key], want[key])
             for key in ("tok_emb", "norm", "lm_head")] + [
        (key, got["layers"][key], w) for key, w in want["layers"].items()]
    assert len(pairs) == 12
    return pairs


# meshes that fill the 8 ranks, each with an axis that does not divide
# what it splits: (impl, mesh axes, widths over SHAPE's)
UNEVEN = [
    # 3 kv heads (and 6 heads of 16) over tp 2: every tp rank runs
    # attention on all heads; vocab 250 and ffn 200 split evenly
    ("flash", dict(dp=4, tp=2), dict(dim=96, n_heads=6, n_kv_heads=3,
                                     ffn_dim=200, vocab_size=250)),
    # ffn 250 over tp 4: w1/w3 columns and w2 rows 63, 63, 63, 61; vocab
    # 510 over tp 4: lm_head columns 128, 128, 128, 126, gathered
    ("xla", dict(dp=2, tp=4), dict(ffn_dim=250, vocab_size=510)),
    # vocab 510 over fsdp 4: tok_emb rows 128, 128, 128, 126
    ("flash", dict(dp=2, fsdp=4), dict(vocab_size=510)),
    # dim 100 over fsdp 8: every weight's model dim 13 a rank, 9 on the last
    ("xla", dict(fsdp=8), dict(dim=100, n_heads=10, n_kv_heads=5)),
]
UNEVEN_STEPS = 3


@pytest.mark.parametrize("impl,axes,widths", UNEVEN,
                         ids=["tp2_kv3", "tp4_ffn250", "fsdp4_vocab510",
                              "fsdp8_dim100"])
def test_uneven_mesh_matches_jax(port, impl, axes, widths):
    """A mesh whose axes do not divide a weight, as JAX computes on it:
    each rank's ``forward`` block of the logits against its slice of
    JAX's, then 3 ``make_train_step`` steps against JAX's on the same mesh
    shape from the same weights on the same global batch: the losses,
    the gathered parameters after them and the first step's gathered
    gradients, at ``test_train_step_on_dp2_fsdp2_tp2_matches_jax``'s
    tolerances. JAX's side takes its weights whole and places them by
    ``param_specs`` inside its program (GSPMD pads an uneven split;
    ``device_put`` refuses one)."""
    shape = dict(SHAPE, **widths)
    cfg = jl.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                         attention_impl=impl, **shape)
    jp = jl.init_params(cfg, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.array, jp)  # copies: JAX's step donates jp
    dp, fsdp, tp = (axes.get(a, 1) for a in ("dp", "fsdp", "tp"))
    toks = np.random.RandomState(11).randint(
        0, cfg.vocab_size, size=(8, 32)).astype(np.int32)
    mesh = _jmesh(**axes)
    t = jax.device_put(jnp.asarray(toks), NamedSharding(mesh, data_spec()))
    want_logits = np.asarray(jax.jit(
        lambda p, x: jl.forward(cfg, p, x, mesh))(jp, t))
    for logits, r0, c0 in port("sp_call", "forward", shape, tree, toks,
                               impl, dp, 1, fsdp, tp):
        rows = logits.shape[0]
        assert logits.shape == (8 // (dp * fsdp), 32, cfg.vocab_size)
        np.testing.assert_allclose(logits, want_logits[r0:r0 + rows],
                                   rtol=2e-4, atol=2e-4)
    want_grads = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p, x: jl.loss_fn(cfg, p, x, mesh)))(jp, t))
    init_state, _, train_step, _ = jl.make_train_step(
        cfg, mesh, learning_rate=LR, loss_chunk=0)
    state = (jp, init_state(jax.random.key(0))[1])
    want = []
    for _ in range(UNEVEN_STEPS):
        state, loss = train_step(state, t)
        want.append(float(loss))
    results = port("sp_call", "train", shape, tree, toks, impl, False, 0,
                   UNEVEN_STEPS, LR, dp, 1, fsdp, tp, with_grads=True)
    for losses, _, _, _ in results:
        np.testing.assert_allclose(losses, want, rtol=1e-4)
    got_params, got_grads = results[0][1], results[0][3]
    for key, g, w in _pairs(got_params, jax.tree.map(np.asarray, state[0])):
        assert g.shape == w.shape, (key, g.shape, w.shape)
        diff = np.abs(g - w)
        assert np.mean(diff > PARAM_ATOL) <= PARAM_OUTLIER_FRAC, (
            key, np.sort(diff.ravel())[-5:])
        assert diff.max() <= LR * UNEVEN_STEPS, (key, diff.max())
    for key, g, w in _pairs(got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL,
                                   err_msg=key)
