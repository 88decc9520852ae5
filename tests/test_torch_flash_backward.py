"""Parity of the PyTorch port's flash-attention backward with the JAX package.

The port's plain version of the K2/K3 kernels (``_flash_bwd_reference``) is
held against the JAX Pallas backward kernels run in interpret mode, and the
gradients of its public entries against ``jax.vjp`` of JAX's, on the same
numpy inputs. The CUDA kernels themselves run only on the card
(``chip_smoke.py``); here a CPU tensor takes the plain versions through the
same autograd function, and no kernel launch is counted. The port runs in a
spawned child (``_port_proc``)."""

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


def _inputs(b, h, kvh, s, hd, seed, layout="bhsd"):
    rng = np.random.RandomState(seed)
    shape_q = (b, h, s, hd) if layout == "bhsd" else (b, s, h, hd)
    shape_kv = (b, kvh, s, hd) if layout == "bhsd" else (b, s, kvh, hd)
    return (rng.randn(*shape_q).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32),
            rng.randn(*shape_q).astype(np.float32))


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_interpreted_pallas_kernels(port, rep, causal):
    """(dq, dk, dv) of the port's plain K2/K3 against the TPU kernels
    themselves, interpreted on the CPU, on the same o and lse: fp32,
    s=256, hd=128, GQA rep 1 and 2."""
    h = 2
    q, k, v, g = _inputs(1, h, h // rep, 256, 128, seed=rep + 2 * causal)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        o, lse = jfa._flash_fwd_tpu(jq, jk, jv, causal, 128, 128)
        want = jfa._flash_bwd_tpu(jq, jk, jv, o, lse, jg, causal, 128, 128)
    finally:
        jfa._INTERPRET = old
    got = port("flash_bwd_reference", q, k, v, np.asarray(o),
               np.asarray(lse), g, causal)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x, np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("entry", ["flash_attention_bhsd", "flash_attention"])
@pytest.mark.parametrize("causal", [True, False])
def test_entry_gradients_match_jax_vjp(port, entry, causal):
    """``torch.autograd.grad`` through the port's entry on the CPU against
    ``jax.vjp`` of JAX's same entry (GQA rep 2); the CPU path launches no
    kernel."""
    layout = "bhsd" if entry == "flash_attention_bhsd" else "bshd"
    q, k, v, g = _inputs(2, 4, 2, 96, 64, seed=5 + causal, layout=layout)
    fn = getattr(jfa, entry)
    _, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, causal), jnp.asarray(q),
                     jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    before, after, *got = port("flash_vjp", entry, q, k, v, g, causal)
    assert before == after == (0, 0, 0)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("bad", ["dtype", "lse_dtype", "head_dim", "heads",
                                 "contiguous", "lse_shape", "length"])
def test_bwd_wrapper_refuses_what_the_kernels_do_not_take(port, bad):
    """The K2/K3 launch wrapper validates before it builds or launches."""
    assert port("bwd_wrapper_refusal", bad) == (
        "TypeError" if bad in ("dtype", "lse_dtype") else "ValueError")
    assert port("bwd_launches") == (0, 0)
