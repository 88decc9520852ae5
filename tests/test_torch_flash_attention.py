"""Parity of the PyTorch port's flash-attention forward with the JAX package.

The port's plain version of the K1 kernel (``_attention_reference``) is held
against the JAX Pallas forward kernel run in interpret mode, and its public
entries against JAX's on the same numpy inputs. The CUDA kernel itself runs
only on the card (``chip_smoke.py``); here a CPU tensor takes the plain
version and the kernel's launch count stays 0. The port runs in a spawned
child (``_port_proc``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_proc import spawn
from ray_tpu.ops import flash_attention as jfa


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        yield call


def _qkv(b, h, kvh, s, hd, seed=0, layout="bhsd"):
    rng = np.random.RandomState(seed)
    shape_q = (b, h, s, hd) if layout == "bhsd" else (b, s, h, hd)
    shape_kv = (b, kvh, s, hd) if layout == "bhsd" else (b, s, kvh, hd)
    return (rng.randn(*shape_q).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32))


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_interpreted_pallas_kernel(port, rep, causal):
    """(o, lse) of the port's plain K1 against the TPU kernel itself,
    interpreted on the CPU: fp32, s=256, hd=128, GQA rep 1 and 2."""
    h = 2
    q, k, v = _qkv(1, h, h // rep, 256, 128, seed=rep + 2 * causal)
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        want_o, want_lse = jfa._flash_fwd_tpu(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=128, block_k=128)
    finally:
        jfa._INTERPRET = old
    got_o, got_lse = port("attention_reference", q, k, v, causal)
    assert got_lse.shape == want_lse.shape == (1, h, 256, 1)
    np.testing.assert_allclose(got_o, np.asarray(want_o), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got_lse, np.asarray(want_lse), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("kvh", [4, 2])
def test_flash_attention_bshd_matches_jax(port, kvh):
    q, k, v = _qkv(2, 4, kvh, 128, 64, seed=kvh, layout="bshd")
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = port("flash_attention_bshd", q, k, v)
    assert got.shape == q.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_xla_attention_bhsd_matches_jax(port, causal):
    q, k, v = _qkv(1, 4, 2, 96, 64, seed=7)
    want = jfa._xla_attention_bhsd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal)
    got, plain_k1 = port("attention_bhsd", q, k, v, causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    # the plain K1 agrees with it at sq == sk (top-left == bottom-right)
    np.testing.assert_allclose(plain_k1, got, rtol=1e-5, atol=1e-5)


def test_cpu_path_counts_no_kernel_launch_and_has_gradients(port):
    q, k, v = _qkv(1, 4, 2, 64, 64, seed=3)
    before, after, dq, dk, dv = port("cpu_path_gradients", q, k, v)
    assert before == after == 0
    _, vjp = jax.vjp(lambda q, k, v: jfa._xla_attention_bhsd(
        q, k, v, True), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.ones(q.shape, jnp.float32))
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "heads", "contiguous",
                                 "length"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(port, bad):
    """The launch wrapper validates before it builds or launches."""
    assert port("wrapper_refusal", bad) == (
        "TypeError" if bad == "dtype" else "ValueError")
    assert port("launches") == 0


def test_build_raises_without_nvcc(port, tmp_path):
    stable, err = port("build_without_nvcc", str(tmp_path))
    assert stable  # the library path is keyed by the source's hash
    assert "nvcc" in err
