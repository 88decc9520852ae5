"""The port's actor-plane pipeline (``ray_tpu_torch.train.pipeline_actors``:
``PipelineStage`` actors, the 1F1B order, ``ActorPipeline`` and
``CompiledActorPipeline`` on the compiled DAG) against the JAX package's
single-stage ``make_train_step``, as ``test_pipeline_actors.py`` holds the
JAX pipeline: JAX's test config, JAX's init (key 0) carried into every
stage through ``params=``, rtol 2e-3 on the losses. The stages run on a CPU
cluster of the port started in the torch child (``_port_proc``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_proc import spawn
from ray_tpu.models.llama import LlamaConfig, init_params, make_train_step
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu_torch.train.pipeline_actors import _one_f_one_b_order

SHAPE = dict(vocab_size=96, dim=48, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=96, max_seq_len=16)   # test_pipeline_actors.py's CFG
CFG = LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, **SHAPE)
STEPS, LR, S, M = 3, 1e-2, 2, 2
TOKENS = np.asarray(jax.random.randint(
    jax.random.key(1), (4, 16), 0, CFG.vocab_size, dtype=jnp.int32))


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        yield call


@pytest.fixture(scope="module")
def jax_losses():
    mesh = MeshSpec().build(jax.devices()[:1])
    init, shard, step, ds = make_train_step(CFG, mesh, learning_rate=LR)
    state = shard(init(jax.random.key(0)))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jax.device_put(jnp.asarray(TOKENS), ds))
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def pipelines(port):
    weights = jax.tree.map(np.array, init_params(CFG, jax.random.key(0)))
    return port("pipeline_actors", SHAPE, weights, TOKENS, LR, STEPS, S, M)


def test_one_f_one_b_order_shape():
    ops = _one_f_one_b_order(S=2, M=4, sid=0)
    assert ops.count(("F", 0)) == 1
    assert [o for o in ops if o[0] == "F"] == [("F", m) for m in range(4)]
    assert [o for o in ops if o[0] == "B"] == [("B", m) for m in range(4)]
    # stage 0 warms up with S - sid = 2 forwards before its first backward
    assert ops[:2] == [("F", 0), ("F", 1)] and ops[2] == ("B", 0)
    # last stage: strict alternation after a single warmup forward
    ops_last = _one_f_one_b_order(S=2, M=4, sid=1)
    assert ops_last[:4] == [("F", 0), ("B", 0), ("F", 1), ("B", 1)]


@pytest.mark.parametrize("which", ["eager", "compiled"])
def test_actor_pipeline_matches_single_stage(pipelines, jax_losses, which):
    losses, _ = pipelines[which]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3)
    assert losses[-1] < losses[0]


def test_compiled_matches_eager(pipelines):
    np.testing.assert_allclose(pipelines["compiled"][0],
                               pipelines["eager"][0], rtol=1e-6)


@pytest.mark.parametrize("which", ["eager", "compiled"])
def test_stages_hand_on_their_activations_and_gradients(pipelines, which):
    """Each step stage 0 hands on M activations and stage 1 M gradients,
    each a CPU tensor of (B/M, seq, dim) in the compute dtype (fp32 here);
    no flash kernel runs on the CPU."""
    _, stats = pipelines[which]
    per = (TOKENS.shape[0] // M) * TOKENS.shape[1] * SHAPE["dim"] * 4
    assert [len(s) for s in stats] == [STEPS] * S
    for stage in stats:
        for step in stage:
            assert step == {"k1": 0, "k2": 0, "k3": 0,
                            "handoff_bytes": M * per}


def test_stages_from_a_seed_match_the_ports_single_stage(port):
    """Without ``params`` each stage draws the whole tree from the seed and
    keeps its slice: the pipeline's losses are the port's own
    ``make_train_step``'s from the same seed."""
    want = port("train_from_seed", SHAPE, TOKENS, LR, 2)
    got = port("pipeline_actors", SHAPE, None, TOKENS, LR, 2, S, M)
    for which in ("eager", "compiled"):
        np.testing.assert_allclose(got[which][0], want, rtol=1e-5)
