"""Parity of the PyTorch port's Llama model with the JAX package on `tiny`
(fp32), with the JAX weights carried across by ``params_from_jax``. The
port runs in a spawned child (``_port_proc``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_proc import spawn
from ray_tpu.models import llama as jl

SHAPE = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=256, max_seq_len=256)  # LlamaConfig.tiny


def _jcfg(**kw):
    return jl.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                          **SHAPE, **kw)


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        yield call


@pytest.fixture(scope="module")
def weights():
    jp = jl.init_params(_jcfg(), jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _tokens(b=2, s=24, seed=0):
    return np.random.RandomState(seed).randint(
        0, SHAPE["vocab_size"], size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_matches_jax(port, weights, impl):
    jp, tree = weights
    toks = _tokens()
    want = jl.forward(_jcfg(attention_impl=impl), jp, jnp.asarray(toks))
    got = port("forward", SHAPE, tree, toks, impl)
    assert got.shape == (2, 24, SHAPE["vocab_size"])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_fn_matches_jax(port, weights, impl):
    jp, tree = weights
    toks = _tokens(seed=1)
    want = jl.loss_fn(_jcfg(attention_impl=impl), jp, jnp.asarray(toks))
    got = port("forward", SHAPE, tree, toks, impl, loss=True)
    np.testing.assert_allclose(got, float(want), rtol=1e-4)


def test_params_from_jax_keeps_keys_shapes_values(port, weights):
    _, tree = weights
    got = port("convert", tree)
    assert got.keys() == tree.keys()
    assert got["layers"].keys() == tree["layers"].keys()
    leaves = [(got[k], tree[k]) for k in ("tok_emb", "norm", "lm_head")] + [
        (got["layers"][k], tree["layers"][k]) for k in tree["layers"]]
    assert len(leaves) == 12
    for (value, dtype), want in leaves:
        assert dtype == "torch.float32" and value.shape == want.shape
        np.testing.assert_array_equal(value, want)
    # bf16 leaves come across exactly, as bf16
    tb = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      tree)
    value, dtype = port("convert", tb)["lm_head"]
    assert dtype == "torch.bfloat16"
    np.testing.assert_array_equal(value, tb["lm_head"].astype(np.float32))


@pytest.mark.parametrize("preset", ["tiny", "llama2_7b", "llama3_8b"])
def test_presets_and_num_params_match_jax(port, preset):
    jc = getattr(jl.LlamaConfig, preset)()
    tc = port("presets")[preset]
    assert tc["num_params"] == jc.num_params()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "ffn_dim", "rope_theta", "norm_eps", "max_seq_len",
              "attention_impl", "head_dim"):
        assert tc[f] == getattr(jc, f), f
    assert tc["dtype"] == "torch.bfloat16"
    assert tc["param_dtype"] == "torch.float32"


def test_init_params_layout_and_count(port):
    f = port("init_params_facts")
    assert f["n"] == f["num_params"] == jl.LlamaConfig.tiny().num_params()
    assert f["wq"] == (2, 128, 128) and f["w2"] == (2, 256, 128)
    assert f["same"]  # same seed, same weights
    assert abs(f["w2_std"] - 256 ** -0.5) < 0.01  # N(0, 1/fan_in)


def test_rms_norm_and_rope_match_jax(port):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 4, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    bpos = np.stack([pos, pos + 5])  # per-row positions, as decode uses
    xb = np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    got = port("norm_and_rope", SHAPE, x, w, pos, bpos, xb)
    jc = _jcfg()
    jcos, jsin = jl.rope_tables(jc, jnp.asarray(pos))
    jcos2, jsin2 = jl.rope_tables(jc, jnp.asarray(bpos))
    want = dict(
        rms=jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
        cos=jcos, sin=jsin,
        rope=jl.apply_rope(jnp.asarray(x), jcos, jsin),
        rope_bhsd=jl.apply_rope_bhsd(jnp.asarray(xb), jcos, jsin),
        rope_rows=jl.apply_rope(jnp.asarray(x), jcos2, jsin2))
    for key, w_ in want.items():
        np.testing.assert_allclose(got[key], np.asarray(w_), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_not_ported_yet(port, weights, impl):
    """With no sequence-parallel mesh (the port has none yet), "ring" and
    "ulysses" take plain attention, as JAX's ``forward(..., mesh=None)``
    does."""
    jp, tree = weights
    toks = _tokens(seed=2)
    want = jl.forward(_jcfg(attention_impl=impl), jp, jnp.asarray(toks),
                      mesh=None)
    got = port("forward", SHAPE, tree, toks, impl)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_entry_points_default_to_cuda(port, weights):
    """No device means CUDA; where there is none, they raise rather than
    move to the CPU."""
    got = port("cuda_default_errors", SHAPE, weights[1])
    if got["cuda_available"]:
        pytest.skip("this machine has CUDA: the default device is valid")
    for name in ("init_params", "params_from_jax", "make_train_step"):
        assert got[name] is not None and "CUDA" in got[name], name
