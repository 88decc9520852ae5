"""Parity of the PyTorch port's pipeline parallelism
(``ray_tpu_torch.parallel.pipeline``) and the rest of its ``parallel/mesh.py``
with the JAX package's.

``tests/test_pipeline.py``'s five tests against the port (two stages, pp x
dp x tp, four stages, the stacking roundtrip, the uneven stage split
rejected), widened: each training case runs 3 AdamW steps of
``make_pipeline_train_step`` from JAX's weights (``params_from_jax``) on
the same numpy tokens and is held to JAX's ``make_pipeline_train_step`` on
the same mesh shape (losses, gathered stage-stacked parameters), to
``jax.grad`` of JAX's loss (the first step's gathered gradients: the
pipeline computes the single-stage loss) and to the port's own
single-stage ``make_train_step`` (losses, parameters, gradients), at
``test_train_step_on_dp2_fsdp2_tp2_matches_jax``'s tolerances. The cases
cover 2 and 4 stages, dp, fsdp, tp (3 kv heads over tp 2 too), sp with
"xla" and "flash", one microbatch, and data ranks holding fewer rows than
there are microbatches (with and without remat). Then what JAX refuses
(ring attention under pp, a batch the microbatches do not divide),
``ShardingRules`` and ``host_local_mesh_info`` against JAX's, and the
CUDA default.

fp32 on the CPU, the tiny Llama of ``test_pipeline.py`` (4 layers, dim 64,
4 heads, 2 kv heads). Every mesh fills the 8 ranks of one gloo group: the
port runs in a spawned child (``_port_proc``) leading 8 rank processes
(``_port_ranks``); JAX runs on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec

from _port_proc import spawn
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import (MeshSpec, ShardingRules,
                                   host_local_mesh_info)
from ray_tpu.parallel.pipeline import (make_pipeline_train_step,
                                       stack_stages, unstack_stages)

WORLD = 8
SHAPE = dict(vocab_size=128, dim=64, n_layers=4, n_heads=4, n_kv_heads=2,
             ffn_dim=128, max_seq_len=32)
# 6 heads and 3 kv heads of 16: tp 2 cuts a kv head, so every tp rank
# runs attention on all of them
KV3 = dict(SHAPE, dim=96, n_heads=6, n_kv_heads=3)
STEPS, LR = 3, 1e-2
# test_torch_model_parallel.py's tolerances
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
PARAM_OUTLIER_FRAC = 1e-3
GRAD_ATOL = 1e-5
CALL_TIMEOUT_S = 120  # each call to the port's child, its 8 ranks' start too

# id -> (impl, mesh axes, microbatches, batch, widths, remat)
CASES = {
    "two_stages_fsdp2_tp2": ("xla", dict(pp=2, fsdp=2, tp=2), 2, 8, SHAPE,
                             False),
    "dp_and_tp": ("flash", dict(pp=2, dp=2, tp=2), 4, 8, SHAPE, False),
    "four_stages_one_microbatch": ("xla", dict(pp=4, dp=2), 1, 8, SHAPE,
                                   False),
    "sp_xla": ("xla", dict(pp=2, dp=2, sp=2), 2, 8, SHAPE, False),
    "sp_flash": ("flash", dict(pp=2, fsdp=2, sp=2), 4, 8, SHAPE, False),
    "tp2_kv3": ("flash", dict(pp=2, dp=2, tp=2), 4, 8, KV3, False),
    # batch 4 over dp 2 x fsdp 2: one row a data rank, 4 microbatches
    "fewer_rows_than_microbatches": ("xla", dict(pp=2, dp=2, fsdp=2), 4, 4,
                                     SHAPE, False),
    "fewer_rows_remat": ("xla", dict(pp=2, dp=2, fsdp=2), 4, 4, SHAPE,
                         True),
}


@pytest.fixture(scope="module")
def port():
    with spawn(timeout=CALL_TIMEOUT_S) as call:
        call("sp_start", WORLD)
        yield call
        call("sp_stop")


def _jcfg(shape, impl="xla"):
    return jl.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                          attention_impl=impl, **shape)


def _tokens(batch, seed=1):
    return np.random.RandomState(seed).randint(
        0, SHAPE["vocab_size"], size=(batch, 32)).astype(np.int32)


_JAX = {}  # JAX's side of a case, shared by the cases that differ in remat


def _jax_side(impl, axes, n_micro, batch, shape):
    """JAX's weights (numpy copies), the losses and stage-stacked
    parameters after STEPS steps of its ``make_pipeline_train_step``, and
    ``jax.grad`` of its single-device loss on the first step, stacked."""
    key = (impl, tuple(sorted(axes.items())), n_micro, batch,
           tuple(sorted(shape.items())))
    if key in _JAX:
        return _JAX[key]
    cfg = _jcfg(shape, impl)
    S = axes["pp"]
    jp = jl.init_params(cfg, jax.random.key(0))
    tree = jax.tree.map(np.array, jp)  # copies: the step donates its state
    toks = _tokens(batch)
    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p, x: jl.loss_fn(cfg, p, x)))(jp, toks))
    grads["layers"] = stack_stages(grads["layers"], S)
    mesh = MeshSpec(**axes).build(jax.devices()[:WORLD])
    _, shard_state, train_step, data_sharding = make_pipeline_train_step(
        cfg, mesh, n_microbatches=n_micro, learning_rate=LR)
    params = {**jp, "layers": stack_stages(jp["layers"], S)}
    state = shard_state((params, optax.adamw(LR).init(params)))
    t = jax.device_put(toks, data_sharding)
    losses = []
    for _ in range(STEPS):
        state, loss = train_step(state, t)
        losses.append(float(loss))
    _JAX[key] = tree, toks, losses, jax.tree.map(np.asarray, state[0]), \
        jax.tree.map(np.asarray, grads)
    return _JAX[key]


def _pairs(got, want):
    pairs = [(key, got[key], want[key])
             for key in ("tok_emb", "norm", "lm_head")] + [
        (key, got["layers"][key], w) for key, w in want["layers"].items()]
    assert len(pairs) == 12
    return pairs


def _hold_params(got, want, steps):
    for key, g, w in _pairs(got, want):
        assert g.shape == w.shape, (key, g.shape, w.shape)
        diff = np.abs(g - w)
        assert np.mean(diff > PARAM_ATOL) <= PARAM_OUTLIER_FRAC, (
            key, np.sort(diff.ravel())[-5:])
        assert diff.max() <= LR * steps, (key, diff.max())


def _hold_grads(got, want):
    for key, g, w in _pairs(got, want):
        assert g.shape == w.shape, (key, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL,
                                   err_msg=key)


def _stacked(tree, n_stages):
    return {**tree, "layers": stack_stages(tree["layers"], n_stages)}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_train_step_matches_jax(port, case):
    """3 steps of the port's GPipe on an 8-rank mesh against JAX's
    ``make_pipeline_train_step`` on the same mesh shape from the same
    weights and tokens: every rank's losses, and the gathered
    stage-stacked parameters after the steps; the gathered gradients of
    the first step against ``jax.grad`` of JAX's single-device loss; and
    all three against the port's single-stage ``make_train_step``. The
    CPU path launches no kernel."""
    impl, axes, n_micro, batch, shape, remat = CASES[case]
    tree, toks, want, want_params, want_grads = _jax_side(
        impl, axes, n_micro, batch, shape)
    results = port("sp_call", "pipeline_train", shape, tree, toks, impl,
                   axes, n_micro, STEPS, LR, remat)
    for losses, launches, _ in results:
        np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
        assert launches == (0, 0, 0, 0)
    assert want[-1] < want[0]
    params, grads, (one_losses, one_params, one_grads) = results[0][2]
    _hold_params(params, want_params, STEPS)
    _hold_grads(grads, want_grads)
    S = axes["pp"]
    np.testing.assert_allclose(results[0][0], one_losses, rtol=LOSS_RTOL)
    _hold_params(params, _stacked(one_params, S), STEPS)
    _hold_grads(grads, _stacked(one_grads, S))


def test_stage_stacking_roundtrip(port):
    """``stack_stages`` (L, ...) -> (S, L/S, ...) as JAX's, and
    ``unstack_stages`` back."""
    params = {"w": np.arange(24.0, dtype=np.float32).reshape(4, 3, 2)}
    stacked, back = port("stack_roundtrip", params, 2)
    assert stacked["w"].shape == (2, 2, 3, 2)
    np.testing.assert_array_equal(stacked["w"],
                                  np.asarray(stack_stages(params, 2)["w"]))
    np.testing.assert_array_equal(back["w"], params["w"])
    np.testing.assert_array_equal(
        back["w"], np.asarray(unstack_stages(stack_stages(params, 2))["w"]))


def test_uneven_stage_split_rejected(port):
    """3 layers over pp 2: JAX's ``AssertionError`` naming the split, from
    both."""
    bad = dict(vocab_size=64, dim=32, n_layers=3, n_heads=2, n_kv_heads=2,
               ffn_dim=64, max_seq_len=16)
    with pytest.raises(AssertionError, match="divide"):
        make_pipeline_train_step(_jcfg(bad), MeshSpec(pp=2).build(
            jax.devices()[:2]), n_microbatches=2)
    kind, text = port("pipeline_refusal", bad, "xla", {"pp": 2})
    assert kind == "AssertionError" and "divide" in text, text


def test_refuses_what_jax_refuses(port):
    """Ring attention under pp, and a batch of 6 over 4 microbatches:
    ``AssertionError`` from JAX and from the port, the second from the
    train step on every rank."""
    with pytest.raises(AssertionError):
        make_pipeline_train_step(_jcfg(SHAPE, "ring"), MeshSpec(
            pp=2, sp=2).build(jax.devices()[:4]), n_microbatches=2)
    kind, _ = port("pipeline_refusal", SHAPE, "ring", {"pp": 2, "sp": 2})
    assert kind == "AssertionError"
    mesh = MeshSpec(pp=2).build(jax.devices()[:2])
    _, shard_state, train_step, ds = make_pipeline_train_step(
        _jcfg(SHAPE), mesh, n_microbatches=4)
    params = jl.init_params(_jcfg(SHAPE), jax.random.key(0))
    params = {**params, "layers": stack_stages(params["layers"], 2)}
    state = shard_state((params, optax.adamw(3e-4).init(params)))
    with pytest.raises(AssertionError, match="divisible"):
        train_step(state, jax.device_put(_tokens(6), ds))
    for kind, text in port("sp_call", "pipeline_refuses_batch", SHAPE,
                           {"pp": 2, "dp": 2, "tp": 2}, 4, _tokens(6)):
        assert kind == "AssertionError" and "divisible" in text, text


def test_sharding_rules_match_jax(port):
    """``ShardingRules(table).spec(name)``: the named entry's spec, and
    ``P()`` for a name the table does not hold, as JAX's."""
    rules = {"embed": ("fsdp", "tp"), "heads": (None, "tp"),
             "batch": (("dp", "fsdp"), "sp")}
    names = ["embed", "heads", "batch", "absent"]
    jrules = ShardingRules({k: PartitionSpec(*v) for k, v in rules.items()})
    want = [tuple(jrules.spec(name)) for name in names]
    assert port("sharding_rules", rules, names) == want
    assert want[-1] == ()


def test_host_local_mesh_info(port):
    """Each rank of pp 2 x dp 2 x tp 2 holds one mesh position, its own:
    ``local_coords`` its coordinate on every axis, ``process_index`` its
    rank, ``process_count`` the world size. JAX's one process holds all 8
    CPU devices (``process_count`` 1, 8 coordinates): the same keys, the
    same coordinates between them."""
    axes = {"pp": 2, "dp": 2, "tp": 2}
    mesh = MeshSpec(**axes).build(jax.devices()[:WORLD])
    want = host_local_mesh_info(mesh)
    got = port("sp_call", "mesh_info", axes)
    assert set(got[0]) - {"rank", "coords"} == set(want)
    for r, info in enumerate(got):
        assert info["process_index"] == info["rank"] == r
        assert info["process_count"] == WORLD
        assert info["local_coords"] == [info["coords"]]
    assert sorted(c for info in got for c in info["local_coords"]) == \
        sorted(want["local_coords"])
    assert want["process_count"] == 1


def test_entry_point_defaults_to_cuda(port):
    """``make_pipeline_train_step`` with no device asks for CUDA: where
    there is none it raises naming it instead of running on the CPU."""
    got = port("pipeline_cuda_default_errors", SHAPE)
    if got["cuda_available"]:
        pytest.skip("this machine has CUDA: the default device is valid")
    text = got["make_pipeline_train_step"]
    assert text is not None and "CUDA" in text
