"""Parity of the PyTorch port's Vision Transformer (``ray_tpu_torch.models.
vit``) with the JAX package's.

``tests/test_vit.py``'s four tests against the port (patchify layout,
parameter count, a sharded step that learns, flash against xla), then the
port against JAX on the same numpy inputs: the tiny config's ``forward``,
5 ``make_train_step`` steps on one device and on dp 2 x fsdp 2 x tp 2, one
mesh whose tp splits a head (6 heads over tp 4, 10 classes over tp 4),
one with pp 2 as a replica axis (pp 2 x dp 2 x fsdp 2), and
``params_from_jax``. fp32 on the CPU; the weights are JAX's with a nonzero
head (JAX's initial head is zero, so a first step would move the head
alone). The port runs in a spawned child (``_port_proc``) leading 8 gloo
rank processes (``_port_ranks``); JAX runs on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from _port_proc import spawn
from ray_tpu.models import vit as jv
from ray_tpu.parallel.mesh import MeshSpec, logical_to_sharding

WORLD = 8
TINY = dict(image_size=32, patch_size=8, dim=64, n_layers=2, n_heads=4,
            mlp_dim=128, num_classes=10)
# tp 4 cuts 6 heads of 16 into 1.5 a rank and 10 classes into 3, 3, 3, 1
UNEVEN = dict(TINY, dim=96, n_heads=6)
STEPS, LR = 5, 1e-3
BATCH = 8
CALL_TIMEOUT_S = 120  # each call to the port's child, its 8 ranks' start too


@pytest.fixture(scope="module")
def port():
    with spawn(timeout=CALL_TIMEOUT_S) as call:
        call("sp_start", WORLD)
        yield call
        call("sp_stop")


def _jcfg(shape=TINY, impl="xla"):
    return jv.ViTConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                        attention_impl=impl, **shape)


def _weights(shape=TINY):
    """JAX's initial weights with a nonzero head: (jax tree, numpy tree)."""
    cfg = _jcfg(shape)
    jp = jv.init_params(cfg, jax.random.key(0))
    rng = np.random.RandomState(1)
    jp["head"] = jnp.asarray(0.1 * rng.randn(cfg.dim, cfg.num_classes),
                             jnp.float32)
    jp["head_bias"] = jnp.asarray(0.1 * rng.randn(cfg.num_classes),
                                  jnp.float32)
    # copies: JAX's train step donates its state, numpy views of it would
    # change under the port's side
    return jp, jax.tree.map(np.array, jp)


def _batch(shape=TINY, seed=2):
    rng = np.random.RandomState(seed)
    images = rng.randn(BATCH, shape["image_size"], shape["image_size"],
                       3).astype(np.float32)
    labels = rng.randint(0, shape["num_classes"], size=BATCH).astype(np.int32)
    return images, labels


def _jmesh(dp=1, fsdp=1, tp=1, pp=1):
    n = pp * dp * fsdp * tp
    return MeshSpec(dp=dp, fsdp=fsdp, tp=tp, pp=pp).build(
        jax.devices()[:n])


def _jax_steps(cfg, mesh, jp, images, labels, steps, place):
    """Losses and parameters after ``steps`` of JAX's ``make_train_step``;
    the state placed by ``shard_state`` where ``place``, else whole (an
    uneven split GSPMD pads inside the program, ``device_put`` refuses)."""
    init_state, shard_state, train_step, (img_sh, lbl_sh) = \
        jv.make_train_step(cfg, mesh, learning_rate=LR)
    state = (jp, init_state(jax.random.key(0))[1])
    if place:
        state = shard_state(state)
    x, y = jax.device_put(images, img_sh), jax.device_put(labels, lbl_sh)
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, x, y)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state[0])


def _hold_leaves(got, want):
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == 19
    for path, w in leaves:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


# -- tests/test_vit.py's four, on the port -----------------------------------


def test_patchify_layout(port):
    """The first patch is the top-left 8x8 block, row-major; the whole
    layout is JAX's."""
    cfg = _jcfg()
    img = np.arange(2 * 32 * 32 * 3, dtype=np.float32).reshape(2, 32, 32, 3)
    patches = port("vit_patchify", TINY, img)
    assert patches.shape == (2, cfg.num_patches, cfg.patch_dim)
    np.testing.assert_array_equal(patches[0, 0].reshape(8, 8, 3),
                                  img[0, :8, :8])
    np.testing.assert_array_equal(patches,
                                  np.asarray(jv.patchify(cfg, img)))


def test_forward_shapes_and_param_count(port):
    """``init_params`` (the default bf16 compute) holds ``num_params``
    parameters, the same from the same seed, with a zero head; the presets
    count as JAX's (ViT-B/16 86.5M); the forward gives finite fp32 logits
    of (b, num_classes)."""
    img = np.random.RandomState(1).randn(3, 32, 32, 3).astype(np.float32)
    facts = port("vit_facts", img)
    assert facts["n"] == jv.ViTConfig.tiny().num_params()
    assert facts["same"] and facts["head_zero"] and facts["finite"]
    assert facts["shape"] == (3, 10) and facts["dtype"] == "torch.float32"
    assert facts["num_params"] == {
        name: getattr(jv.ViTConfig, name)().num_params()
        for name in ("tiny", "base", "large")}
    assert facts["num_params"]["base"] == 86_529_256
    assert (facts["head_dim"], facts["num_patches"]) == (64, 196)


def test_sharded_train_step_learns(port):
    """31 steps on dp 2 x fsdp 2 x tp 2 from seed 0 ("xla", lr 1e-2) on a
    fixed batch: the loss halves, the same on every rank."""
    images, labels = _batch()
    results = port("sp_call", "vit_train", TINY, None, images, labels, "xla",
                   31, 1e-2, 2, 2, 2)
    losses = results[0][0]
    assert all(r[0] == losses for r in results)
    assert losses[-1] < losses[0] * 0.5, losses


def test_flash_vs_xla_forward_parity(port):
    """The unmasked flash path against plain attention (the CPU runs the
    kernels' plain versions through the same autograd function)."""
    _, tree = _weights()
    images, _ = _batch()
    np.testing.assert_allclose(port("vit_forward", TINY, tree, images, "xla"),
                               port("vit_forward", TINY, tree, images,
                                    "flash"), rtol=2e-4, atol=2e-4)


# -- the port against JAX ----------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_jax(port, impl):
    """The tiny config's logits from the same weights and images, within
    ``test_vit.py``'s own 2e-4."""
    jp, tree = _weights()
    images, _ = _batch()
    want = np.asarray(jv.forward(_jcfg(impl=impl), jp, images))
    np.testing.assert_allclose(port("vit_forward", TINY, tree, images, impl),
                               want, rtol=2e-4, atol=2e-4)


def test_train_step_matches_jax(port):
    """5 AdamW steps ("flash") on one device: losses within 1e-5, every
    leaf after them within 1e-4 of JAX's ``make_train_step`` on a
    one-device mesh."""
    jp, tree = _weights()
    images, labels = _batch()
    want, want_params = _jax_steps(_jcfg(impl="flash"), _jmesh(), jp, images,
                                   labels, STEPS, place=True)
    losses, params = port("vit_train", TINY, tree, images, labels, STEPS, LR)
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)
    assert want[-1] < want[0]
    _hold_leaves(params, want_params)


@pytest.mark.parametrize("axes,shape", [
    (dict(dp=2, fsdp=2, tp=2), TINY),
    (dict(dp=2, tp=4), UNEVEN),
    (dict(pp=2, dp=2, fsdp=2), TINY),
], ids=["dp2_fsdp2_tp2", "dp2_tp4_6heads", "pp2_dp2_fsdp2"])
def test_sharded_forward_and_train_step_match_jax(port, axes, shape):
    """On an 8-rank mesh: each rank's logits block against its rows of
    JAX's sharded ``forward``, then 5 steps ("flash") against JAX's
    ``make_train_step`` on the same mesh shape: every rank's losses within
    1e-5, the gathered leaves within 1e-4. On dp 2 x tp 4 the 6 heads do
    not split over tp, so every tp rank runs attention on all of them. On
    pp 2 x dp 2 x fsdp 2 pp is a replica axis, as in JAX: each pp slice
    computes the whole model on the same images."""
    jp, tree = _weights(shape)
    images, labels = _batch(shape, seed=3)
    mesh = _jmesh(**axes)
    dp, fsdp, tp, pp = (axes.get(a, 1) for a in ("dp", "fsdp", "tp", "pp"))
    cfg = _jcfg(shape, impl="flash")
    even = shape is TINY
    placed = jax.tree.map(jax.device_put, jp, logical_to_sharding(
        jv.param_specs(cfg), mesh)) if even else jp
    x = jax.device_put(images, NamedSharding(
        mesh, PartitionSpec(("dp", "fsdp"))))
    want_logits = np.asarray(jax.jit(
        lambda p, x: jv.forward(cfg, p, x, mesh))(placed, x))
    for logits, r0 in port("sp_call", "vit_forward", shape, tree, images,
                           "flash", dp, fsdp, tp, pp=pp):
        rows = BATCH // (dp * fsdp)
        assert logits.shape == (rows, shape["num_classes"])
        np.testing.assert_allclose(logits, want_logits[r0:r0 + rows],
                                   rtol=2e-4, atol=2e-4)
    want, want_params = _jax_steps(cfg, mesh, jp, images, labels, STEPS,
                                   place=even)
    results = port("sp_call", "vit_train", shape, tree, images, labels,
                   "flash", STEPS, LR, dp, fsdp, tp, pp=pp)
    for losses, _ in results:
        np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)
    _hold_leaves(results[0][1], want_params)


def test_entry_points_default_to_cuda(port):
    """``init_params`` and ``make_train_step``'s state, called with no
    device, ask for CUDA: where there is none they raise naming it
    instead of running on the CPU."""
    got = port("vit_moe_cuda_default_errors")
    if got["cuda_available"]:
        pytest.skip("this machine has CUDA: the default device is valid")
    for name in ("vit.init_params", "vit.make_train_step"):
        assert got[name] is not None and "CUDA" in got[name], name


def test_params_from_jax_carries_vit_weights(port):
    """``params_from_jax`` takes JAX's ViT parameters (nested numpy) across
    as they are: the same keys, shapes, dtypes and values."""
    _, tree = _weights()
    got = port("convert", tree)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == 19
    for path, want in leaves:
        g = got
        for key in path:
            g = g[key.key]
        values, dtype = g
        assert dtype == "torch.float32", path
        np.testing.assert_array_equal(values, want)
    assert set(got) == set(tree) and set(got["layers"]) == set(tree["layers"])
