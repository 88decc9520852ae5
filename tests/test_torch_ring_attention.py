"""Parity of the PyTorch port's ring-attention pieces with the JAX package.

The hop primitives first: ``flash_chunk_bhsd`` and ``_chunk_xla`` (K4's
plain version) against JAX's ``_chunk_xla`` and the Pallas chunk kernel
interpreted on the CPU, its gradient against ``jax.vjp`` of ``_chunk_xla``,
and ``flash_hop_bwd`` / ``_hop_bwd_xla`` (K5's plain version) against JAX's
``_hop_bwd_xla`` and the interpreted ``_hop_bwd_tpu``, all on the same
numpy inputs in fp32. Then ``ring_attention_sharded`` and
``ulysses_attention_sharded`` on a 4-rank gloo group (one process a rank,
``_port_ranks``) against JAX's on ``MeshSpec(sp=4)``: each rank gets its
sequence shard, and the shards of the output and of the gradients are put
back together. The CUDA kernels run only on the card (``chip_smoke.py``);
here every launch counter stays 0. The port runs in a spawned child
(``_port_proc``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_proc import spawn
from ray_tpu.ops import flash_attention as jfa
from ray_tpu.parallel import ring_attention as jra
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu.parallel.ulysses import ulysses_attention_sharded

SP = 4


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        call("sp_start", SP)
        yield call
        call("sp_stop")


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _hop(b, h, kvh, s, hd, seed, fresh):
    """q, k, v of one hop and the (o, m, l) it starts from: fresh (m =
    -inf) or carried out of a previous plain hop."""
    rng = np.random.RandomState(seed)
    q, k, v, k0, v0 = (_randn(rng, b, n, s, hd)
                       for n in (h, kvh, kvh, kvh, kvh))
    state = (np.zeros((b, h, s, hd), np.float32),
             np.full((b, h, s, 1), -np.inf, np.float32),
             np.zeros((b, h, s, 1), np.float32))
    if not fresh:
        state = tuple(np.asarray(t) for t in jfa._chunk_xla(
            q, k0, v0, *state, False))
    return (q, k, v) + state


def _interpreted(fn, *args):
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        return fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                    for a in args))
    finally:
        jfa._INTERPRET = old


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_chunk_matches_jax_and_interpreted_kernel(port, causal, fresh):
    """(o, m, l) of one hop, FULL and DIAG, from a fresh and a carried
    state: the port's ``_chunk_xla`` and ``flash_chunk_bhsd`` against
    JAX's ``_chunk_xla`` and the Pallas chunk kernel (s 256, hd 128, GQA
    rep 2, 128-row blocks)."""
    args = _hop(1, 4, 2, 256, 128, seed=2 * causal + fresh, fresh=fresh)
    want = jfa._chunk_xla(*args, causal)
    kernel = _interpreted(jfa._flash_chunk_tpu, *args, causal, 128, 128)
    plain, entry, launches = port("chunk", *args, causal)
    assert launches == (0, 0)
    for ref_name, ref in (("_chunk_xla", want), ("kernel", kernel)):
        for got_name, got in (("plain", plain), ("entry", entry)):
            for name, x, w in zip("oml", got, ref):
                np.testing.assert_allclose(
                    x, np.asarray(w), rtol=2e-5, atol=2e-5,
                    err_msg=f"{got_name} {name} vs {ref_name}")


@pytest.mark.parametrize("causal", [True, False])
def test_chunk_gradients_match_jax_vjp(port, causal):
    """The gradients of all six inputs of ``flash_chunk_bhsd`` (autograd
    of ``_chunk_xla``, as JAX's ``_chunk_bwd_rule``) against ``jax.vjp`` of
    JAX's ``_chunk_xla``, from a carried state."""
    args = _hop(2, 4, 2, 48, 32, seed=7 + causal, fresh=False)
    rng = np.random.RandomState(9)
    cot = (_randn(rng, 2, 4, 48, 32), _randn(rng, 2, 4, 48, 1),
           _randn(rng, 2, 4, 48, 1))
    _, vjp = jax.vjp(lambda *a: jfa._chunk_xla(*a, causal),
                     *(jnp.asarray(a) for a in args))
    want = vjp(tuple(jnp.asarray(c) for c in cot))
    got = port("chunk_vjp", *args, causal, *cot)
    for name, x, w in zip(("q", "k", "v", "o", "m", "l"), got, want):
        np.testing.assert_allclose(x, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_hop_bwd_matches_jax_and_interpreted_kernels(port, causal):
    """(dq, dk, dv) of one hop against GLOBAL lse/delta rows (from a
    two-hop forward): the port's ``_hop_bwd_xla`` and ``flash_hop_bwd``
    against JAX's ``_hop_bwd_xla`` and the Pallas dq/dkv kernels (s 256,
    hd 128, GQA rep 2)."""
    q, k, v, o, m, l = _hop(1, 4, 2, 256, 128, seed=11 + causal,
                            fresh=False)
    g = _randn(np.random.RandomState(13), 1, 4, 256, 128)
    o, m, l = jfa._chunk_xla(q, k, v, o, m, l, causal)
    lse = np.asarray(m + jnp.log(l))
    delta = np.asarray(jnp.sum(g * (o / l), axis=-1, keepdims=True))
    args = (q, k, v, g, lse, delta)
    want = jfa._hop_bwd_xla(*args, causal)
    kernel = _interpreted(jfa._hop_bwd_tpu, *args, causal, 128, 128)
    plain, entry, launches = port("hop_bwd", *args, causal)
    assert launches[0] == launches[1] == (0, 0)
    for ref_name, ref in (("_hop_bwd_xla", want), ("kernels", kernel)):
        for got_name, got in (("plain", plain), ("entry", entry)):
            for name, x, w in zip(("dq", "dk", "dv"), got, ref):
                assert x.dtype == np.float32 and x.shape == w.shape
                np.testing.assert_allclose(
                    x, np.asarray(w), rtol=2e-4, atol=2e-4,
                    err_msg=f"{got_name} {name} vs {ref_name}")


@pytest.mark.parametrize("bad", ["dtype", "state_dtype", "head_dim", "heads",
                                 "state_shape", "contiguous"])
def test_chunk_wrapper_refuses_what_the_kernel_does_not_take(port, bad):
    """The K4 launch wrapper validates before it builds or launches."""
    assert port("chunk_refusal", bad) == (
        "TypeError" if bad in ("dtype", "state_dtype") else "ValueError")


@pytest.mark.parametrize("sp", [2, 4])
def test_dispatch_hop_matches_jax(port, sp):
    """FULL / DIAG / SKIP for every rank and step, causal and not."""
    got = port("dispatch_hops", sp)
    assert len(got) == 2 * sp * sp
    for (causal, idx, i), hop in got.items():
        want = jra._dispatch_hop(causal, idx, i, sp, lambda a: 0,
                                 lambda a: 1, lambda a: 2, None)
        assert hop == int(want), (causal, idx, i)


def _qkvg(b, s, h, kvh, hd, seed):
    rng = np.random.RandomState(seed)
    return (_randn(rng, b, s, h, hd), _randn(rng, b, s, kvh, hd),
            _randn(rng, b, s, kvh, hd), _randn(rng, b, s, h, hd))


def _jax_sharded(fn, q, k, v, g, causal):
    """JAX's sharded attention on MeshSpec(sp=4) and the gradients of
    <out, g>."""
    mesh = MeshSpec(sp=SP).build()

    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, causal=causal),
                           q, k, v)
        return (out,) + vjp(g)

    return [np.asarray(t) for t in jax.jit(run)(q, k, v, g)]


def _port_sharded(port, impl, q, k, v, g, causal):
    """The port's on 4 gloo ranks: each rank's shards, put back together
    along the sequence."""
    parts = port("sp_call", "sharded_attention", impl, SP, q, k, v, g, causal)
    return [np.concatenate([p[i] for p in parts], axis=1) for i in range(4)]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_reference_matches_jax(port, causal):
    """The single-device reference, GQA rep 4."""
    q, k, v, _ = _qkvg(2, 48, 8, 2, 16, seed=60 + causal)
    want = jra.ring_attention_reference(q, k, v, causal)
    got = port("ring_reference", q, k, v, causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
def test_ring_attention_forward_matches_jax(port, h, kvh):
    """MHA and GQA, causal: the output shards against JAX's."""
    q, k, v, g = _qkvg(2, 64, h, kvh, 32, seed=h + kvh)
    want = _jax_sharded(jra.ring_attention_sharded, q, k, v, g, True)
    got = _port_sharded(port, "ring", q, k, v, g, True)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kvh", [4, 2])
def test_ring_attention_gradients_match_jax(port, kvh):
    """The ring-level backward (second ring pass, rotating fp32 dk/dv
    accumulators): dq, dk, dv against JAX's, MHA and GQA."""
    q, k, v, g = _qkvg(1, 64, 4, kvh, 32, seed=20 + kvh)
    want = _jax_sharded(jra.ring_attention_sharded, q, k, v, g, True)
    got = _port_sharded(port, "ring", q, k, v, g, True)
    for name, x, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, w, rtol=5e-4, atol=5e-4, err_msg=name)


def test_ring_attention_non_causal_matches_jax(port):
    """Every hop FULL: output and gradients."""
    q, k, v, g = _qkvg(1, 32, 4, 2, 16, seed=31)
    want = _jax_sharded(jra.ring_attention_sharded, q, k, v, g, False)
    got = _port_sharded(port, "ring", q, k, v, g, False)
    for name, x, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, w, rtol=5e-4, atol=5e-4, err_msg=name)
    # the CPU path launched no kernel on any rank
    assert port("sp_call", "launches") == [(0, 0, 0, 0)] * SP


@pytest.mark.parametrize("kvh", [8, 4])
def test_ulysses_matches_jax(port, kvh):
    """8 heads over sp 4 (2 a rank), MHA and GQA: output and gradients."""
    q, k, v, g = _qkvg(2, 64, 8, kvh, 16, seed=40 + kvh)
    want = _jax_sharded(ulysses_attention_sharded, q, k, v, g, True)
    got = _port_sharded(port, "ulysses", q, k, v, g, True)
    for name, x, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, w, rtol=2e-4, atol=2e-4, err_msg=name)


def test_ulysses_refuses_heads_not_divisible_by_sp(port):
    q, k, v, g = _qkvg(1, 32, 6, 6, 16, seed=50)
    with pytest.raises(RuntimeError, match="divisible by sp=4"):
        port("sp_call", "sharded_attention", "ulysses", SP, q, k, v, g)
