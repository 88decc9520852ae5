"""The PyTorch port's routing of inputs its CUDA kernels do not take.

The JAX package sends what its Pallas kernels do not take to XLA
(``_supported_on_tpu``, ``_chunk_supported``); the port sends what its CUDA
kernels do not take (``_supported_on_cuda``: bf16, head_dim 64 or 128,
``h % kvh == 0``) to the plain versions, on the inputs' own device; a
view the kernels take is copied into a contiguous, 16-byte aligned tensor
(``_kernel_input``) and launches. Here: the predicate's device-independent
part (``_kernel_takes``) on CPU tensors; ``_kernel_input`` on views; the
three public entries at head_dim 32 (bf16), in fp32 and on bf16 views
against JAX's, forward and gradients, with no kernel launch on the CPU;
and the K2/K3 wrapper's alignment check of dO. The port runs in a spawned
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


@pytest.mark.parametrize("case,takes", [
    ("bf16_hd64", True), ("bf16_hd128", True), ("hd32", False),
    ("fp32", False), ("heads", False), ("unaligned_q", True),
    ("unaligned_dO", True)])
def test_kernel_takes(port, case, takes):
    """bf16 at head_dim 64 and 128 is the kernels'; head_dim 32, fp32 and
    heads that are no multiple of the kv heads are not. Layout does not
    route: a q or dO view at an odd storage offset is the kernels' too
    (the entries copy it, ``test_kernel_input_copies_what_tma_cannot_read``),
    as the JAX package has no layout to route on."""
    assert port("kernel_takes", case) is takes


@pytest.mark.parametrize("how", ["aligned", "offset", "transposed"])
def test_kernel_input_copies_what_tma_cannot_read(port, how):
    """A contiguous, 16-byte aligned tensor goes to the kernels as it is;
    a view at an odd storage offset or a transposed view goes as a
    contiguous, aligned copy of the same values."""
    same, contiguous, rem, equal = port("kernel_input", how)
    assert same is (how == "aligned")
    assert contiguous and rem == 0 and equal


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _args(entry, hd, causal, seed):
    """Seeded numpy inputs of ``entry`` (b 1, h 4, kvh 2, s 64) and the
    cotangents of its outputs."""
    rng = np.random.RandomState(seed)
    b, h, kvh, s = 1, 4, 2, 64
    q, g = _randn(rng, b, h, s, hd), _randn(rng, b, h, s, hd)
    k, v = _randn(rng, b, kvh, s, hd), _randn(rng, b, kvh, s, hd)
    rows = (b, h, s, 1)
    if entry == "flash_attention_bhsd":
        return (q, k, v), (g,)
    if entry == "flash_chunk_bhsd":  # a carried state
        state = (_randn(rng, b, h, s, hd), _randn(rng, *rows),
                 np.abs(_randn(rng, *rows)) + 1.0)
        return (q, k, v) + state, (g, _randn(rng, *rows), _randn(rng, *rows))
    # the hop backward against GLOBAL rows of a two-hop forward
    o, m, l = jfa._chunk_xla(q, k, v, *_args("flash_chunk_bhsd", hd,
                                              causal, seed + 1)[0][3:],
                             causal)
    lse = np.asarray(m + jnp.log(l))
    delta = np.asarray(jnp.sum(g * (o / l), axis=-1, keepdims=True))
    return (q, k, v, g, lse, delta), ()


# fp32 throughout: summation order only. bf16 inputs: the hop primitives
# compute in fp32 from them and return fp32 (summation order, and JAX's
# bf16 rounding of p before P V in the chunk: 1e-3); the attention returns
# bf16 o and gradients, which the two packages round at different places
# (JAX's probabilities too): a few 2^-8 steps of each value, 3e-2
def _tol(entry, case):
    if case == "fp32":
        return 1e-4
    return 3e-2 if entry == "flash_attention_bhsd" else 1e-3


ENTRIES = ["flash_attention_bhsd", "flash_chunk_bhsd", "flash_hop_bwd"]


@pytest.mark.parametrize("case", ["hd32", "fp32"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entries_route_what_the_kernels_do_not_take(port, entry, case):
    """Each public entry at head_dim 32 in bf16, and at head_dim 64 in
    fp32, against JAX's same entry on the same inputs: its outputs and the
    gradients of all its inputs (``jax.vjp``). The kernels take neither,
    and no launch is counted."""
    assert _entry_against_jax(port, entry, case) is False


@pytest.mark.parametrize("entry", ENTRIES)
def test_entries_take_views(port, entry):
    """Each public entry on bf16 views at head_dim 64 (q and dO
    transposed, k and v at an odd storage offset) against JAX's same entry
    on the same values. The kernels take them (on the card, through
    ``_kernel_input``'s copies); here, on the CPU, no launch is
    counted."""
    assert _entry_against_jax(port, entry, "view") is True


def _entry_against_jax(port, entry, case):
    """Check ``entry``'s results on ``case``'s inputs against JAX's, and
    that it counted no launch; return whether the kernels take them."""
    hd = 32 if case == "hd32" else 64
    causal = True
    args, cots = _args(entry, hd, causal, seed=len(entry) + hd)
    n_bf16 = 4 if entry == "flash_hop_bwd" else 3
    dt = jnp.float32 if case == "fp32" else jnp.bfloat16
    jargs = [jnp.asarray(a, dt) if i < n_bf16 else jnp.asarray(a)
             for i, a in enumerate(args)]
    fn = getattr(jfa, entry)
    want = fn(*jargs, causal)
    want_outs = [want] if entry == "flash_attention_bhsd" else list(want)
    want_grads = []
    if cots:
        _, vjp = jax.vjp(lambda *a: fn(*a, causal), *jargs)
        want_grads = vjp(tuple(jnp.asarray(c, o.dtype)
                               for c, o in zip(cots, want_outs))
                         if entry != "flash_attention_bhsd"
                         else jnp.asarray(cots[0], dt))
    takes, outs, grads, before, after = port("routed", entry, case, args,
                                             cots, causal)
    assert before == after
    assert len(outs) == len(want_outs) and len(grads) == len(want_grads)
    for i, (x, w) in enumerate(zip(outs + grads, want_outs + list(
            want_grads))):
        tol = _tol(entry, case)
        if case == "view" and i - len(outs) in range(n_bf16):
            # the gradient of a bf16 input, which both packages round to
            # bf16 from fp32 sums in different orders: where the two sums
            # straddle a rounding boundary they differ by one step (2^-8
            # relative); two steps
            tol = max(tol, 2.0 ** -7)
        w = np.asarray(w, np.float32)
        assert x.shape == w.shape, i
        np.testing.assert_allclose(x, w, rtol=tol, atol=tol,
                                   err_msg=f"{entry} {case} result {i}")
    return takes


def test_bwd_wrapper_refuses_an_unaligned_dO(port):
    """K3 reads dO through TMA: a contiguous bf16 dO at storage offset 1
    is refused, naming it; one at offset 8 (16 bytes) is taken."""
    rem, err = port("dO_alignment_check", 1)
    assert rem != 0 and err is not None
    assert "dO not at a 16-byte aligned" in err
    rem, err = port("dO_alignment_check", 8)
    assert rem == 0 and err is None
