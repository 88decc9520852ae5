"""Parity of the PyTorch port's rllib learners (``ray_tpu_torch.rllib``)
with the JAX package's, and the port's versions of the JAX package's
actor-free rllib tests (``test_rllib.py``, ``test_rllib_dqn.py``,
``test_rllib_sac_bc.py``, ``test_rllib_appo_cql.py``, all mid tier).

Each parity case builds the JAX learner, hands its weights to the port's
(``set_weights``: JAX draws its weights with ``jax.random``, which torch
cannot reproduce), and runs 3 updates of both on one seeded numpy batch:
the metrics and the weights after them agree to 1e-5. PPO takes one
minibatch an epoch, so ``jax.random.permutation``'s shuffle drops out of
the loss; SAC's update takes JAX's action noise. The port runs in a
spawned child (``_port_proc``), on the CPU."""

import jax
import numpy as np
import pytest

from _port_proc import spawn
from ray_tpu.rllib.bc import BCLearner
from ray_tpu.rllib.cql import CQLLearner
from ray_tpu.rllib.dqn import DQNLearner, ReplayBuffer
from ray_tpu.rllib.learner import (APPOLearner, PPOLearner, VTraceLearner,
                                   _loss, compute_gae, policy_logits)
from ray_tpu.rllib.sac import SACLearner

N, OBS, ACTS, ACT_DIM = 64, 6, 3, 2
UPDATES = 3
TOL = 1e-5


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        yield call


def _batch(seed=0):
    """Every column any learner reads, seeded: N rows of OBS features."""
    rng = np.random.default_rng(seed)
    term = (rng.random(N) < 0.1).astype(np.float32)
    actions = rng.integers(0, ACTS, N).astype(np.int32)
    return dict(
        obs=rng.normal(size=(N, OBS)).astype(np.float32),
        next_obs=rng.normal(size=(N, OBS)).astype(np.float32),
        actions=actions, action=actions.astype(np.int64),
        logp=rng.normal(-1.1, 0.1, N).astype(np.float32),
        advantages=rng.normal(size=N).astype(np.float32),
        returns=rng.normal(size=N).astype(np.float32),
        rewards=rng.normal(size=N).astype(np.float32),
        reward=rng.normal(size=N).astype(np.float32),
        terminated=term,
        cut=np.maximum(term, rng.random(N) < 0.1).astype(np.float32),
        cont_actions=np.tanh(rng.normal(size=(N, ACT_DIM))).astype(
            np.float32),
        bc_targets=rng.normal(size=(N, ACTS)).astype(np.float32))


def _weights(learner):
    return jax.tree.map(np.asarray, learner.params)


def _sac_noise(learner, n):
    """The two normal draws JAX's next ``SACLearner.update`` makes."""
    _, key = jax.random.split(learner._rng)
    k1, k2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(k, (n, ACT_DIM)))
                     for k in (k1, k2)])


def _columns(b, *names):
    return {k: b[k] for k in names}


# (JAX learner, constructor args, keywords, the arguments of one update);
# the port's learner has the JAX learner's class name
_VTRACE = ("obs", "next_obs", "actions", "logp", "rewards", "terminated",
           "cut")
_REPLAY = ("obs", "next_obs", "actions", "rewards", "terminated")
CASES = {
    "ppo": (PPOLearner, (OBS, ACTS), dict(minibatch_size=N),
            lambda b: (_columns(b, "obs", "actions", "logp", "advantages",
                                "returns"),)),
    "vtrace": (VTraceLearner, (OBS, ACTS), {},
               lambda b: (_columns(b, *_VTRACE),)),
    "appo": (APPOLearner, (OBS, ACTS), dict(target_update_freq=2),
             lambda b: (_columns(b, *_VTRACE),)),
    "dqn": (DQNLearner, (OBS, ACTS), dict(target_update_freq=2),
            lambda b: (_columns(b, *_REPLAY),)),
    "sac": (SACLearner, (OBS, ACT_DIM), {},
            lambda b: (dict(_columns(b, *_REPLAY),
                            actions=b["cont_actions"]),)),
    "bc_discrete": (BCLearner, (OBS, ACTS), dict(discrete=True),
                    lambda b: (b["obs"], b["action"])),
    "bc_continuous": (BCLearner, (OBS, ACTS), dict(discrete=False),
                      lambda b: (b["obs"], b["bc_targets"])),
    "cql": (CQLLearner, (OBS, ACTS), dict(target_update_freq=2),
            lambda b: (_columns(b, "obs", "action", "reward", "next_obs",
                                "terminated"),)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_learner_matches_jax(port, case):
    """3 updates of the port's learner from the JAX learner's weights on
    the same batch: metrics and weights within 1e-5."""
    cls, args, kwargs, update_args = CASES[case]
    b = _batch()
    j = cls(*args, **kwargs)
    w0 = _weights(j)
    calls, want = [], []
    for _ in range(UPDATES):
        extra = {}
        if cls is SACLearner:
            extra = {"noise": _sac_noise(j, N)}
        calls.append(("update", update_args(b), extra))
        want.append(j.update(*update_args(b)))
    got, got_w = port("rl_learner", cls.__name__, args, kwargs, w0, calls,
                      target=cls is APPOLearner)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            g, w = [g[k] for k in w], [w[k] for k in w]
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    want_w = _weights(j)
    assert jax.tree.structure(got_w) == jax.tree.structure(want_w)
    for g, w in zip(jax.tree.leaves(got_w), jax.tree.leaves(want_w)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_ppo_advantages_use_the_population_std(port):
    """JAX normalises PPO's advantages by ``jnp.std``, ddof 0; torch's
    ``.std()`` defaults to ddof 1. On 4 rows the two differ by
    sqrt(4/3), so the loss pins the port to ddof 0."""
    b = _batch(1)
    mb = {k: b[k][:4] for k in ("obs", "actions", "logp", "advantages",
                                "returns")}
    w = _weights(PPOLearner(OBS, ACTS))
    want = _loss(w, mb, 0.2, 0.5, 0.01)
    got = port("rl_ppo_loss", w, mb, 0.2, 0.5, 0.01)
    np.testing.assert_allclose(got, [float(want[0])] + [
        float(a) for a in want[1]], rtol=TOL, atol=TOL)
    # the policy loss is linear in the normalised advantages: with ddof 1
    # it would be sqrt(3/4) of this, far outside the tolerance
    assert abs(got[1]) * (1 - np.sqrt(3 / 4)) > 100 * TOL


def test_params_from_jax_takes_lists(port):
    """A dict of lists of dicts (``init_mlp``'s nest) crosses unchanged:
    the same nesting, containers, values and dtypes."""
    tree = _weights(PPOLearner(OBS, ACTS, hidden=(8,)))
    tree["extra"] = (np.arange(3, dtype=np.float32),)
    got = port("convert_nest", tree)
    assert got.keys() == tree.keys()
    assert isinstance(got["pi"], list) and isinstance(got["extra"], tuple)
    assert len(got["pi"]) == len(tree["pi"]) == 2
    for layer, want in zip(got["pi"] + got["vf"], tree["pi"] + tree["vf"]):
        assert layer.keys() == want.keys() == {"w", "b"}
        for k in ("w", "b"):
            value, dtype, kind = layer[k]
            assert dtype == "torch.float32" and kind == "Tensor"
            np.testing.assert_array_equal(value, want[k])
    np.testing.assert_array_equal(got["extra"][0][0], tree["extra"][0])


def test_learners_default_to_cuda(port):
    got = port("rl_cuda_default_errors")
    if got["cuda_available"]:
        pytest.skip("this machine has CUDA: the default device is valid")
    for name in ("PPOLearner", "VTraceLearner", "APPOLearner", "DQNLearner",
                 "SACLearner", "BCLearner", "CQLLearner"):
        assert got[name] is not None and "CUDA" in got[name], name


# -- the JAX package's actor-free rllib tests, on the port --------------------


def test_gae_math(port):
    rewards = np.array([1.0, 1.0, 1.0], dtype=np.float32)
    values = np.array([0.5, 0.5, 0.5], dtype=np.float32)
    next_values = np.array([0.5, 0.5, 9.9], dtype=np.float32)
    terminated = np.array([0.0, 0.0, 1.0], dtype=np.float32)
    cuts = terminated.copy()
    args = (rewards, values, next_values, terminated, cuts)
    adv, ret = port("rl_gae", *args, gamma=1.0, lam=1.0)
    # terminal step zeroes the bootstrap: ret[2] = 1.0
    assert ret[2] == pytest.approx(1.0)
    # undiscounted returns accumulate backwards: [3, 2, 1]
    assert ret.tolist() == pytest.approx([3.0, 2.0, 1.0])
    assert adv.tolist() == pytest.approx([2.5, 1.5, 0.5])
    # and the JAX package's values, discounted
    got = port("rl_gae", *args, gamma=0.9, lam=0.8)
    for g, w in zip(got, compute_gae(*args, gamma=0.9, lam=0.8)):
        np.testing.assert_array_equal(g, w)


def test_gae_truncation_bootstraps(port):
    """A truncated (not terminated) episode bootstraps from the pre-reset
    state's value and the GAE chain never crosses the boundary."""
    rewards = np.array([1.0, 1.0], dtype=np.float32)
    values = np.array([0.0, 0.0], dtype=np.float32)
    # step 0 truncates with V(final obs)=5; step 1 is a fresh episode
    next_values = np.array([5.0, 0.0], dtype=np.float32)
    terminated = np.array([0.0, 0.0], dtype=np.float32)
    cuts = np.array([1.0, 0.0], dtype=np.float32)
    adv, ret = port("rl_gae", rewards, values, next_values, terminated,
                    cuts, gamma=1.0, lam=1.0)
    # truncated step keeps its bootstrap (1 + 5) and ignores step 1 entirely
    assert adv[0] == pytest.approx(6.0)
    assert adv[1] == pytest.approx(1.0)


def test_learner_update_reduces_loss(port):
    rng = np.random.default_rng(0)
    n = 256
    batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "logp": np.full(n, -0.693, dtype=np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(size=n).astype(np.float32),
    }
    (m1, *_, m2), _ = port("rl_learner", "PPOLearner", (4, 2),
                           dict(lr=1e-2, num_epochs=2, minibatch_size=64),
                           calls=[("update", (batch,), {})] * 6)
    assert np.isfinite(m2["total_loss"])
    # value loss on a FIXED regression target must fall with training
    assert m2["vf_loss"] < m1["vf_loss"]


def test_weights_roundtrip(port):
    """A learner's weights set into another give its policy; JAX's weights
    give JAX's logits in the port, and the port's give the port's logits
    in JAX."""
    obs = np.ones((3, 4), dtype=np.float32)
    _, w = port("rl_learner", "PPOLearner", (4, 2), {})
    _, w2 = port("rl_learner", "PPOLearner", (4, 2), dict(seed=123),
                 weights=w)
    for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(w2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(port("rl_policy_logits", w2, obs),
                               port("rl_policy_logits", w, obs), rtol=1e-6)
    j = PPOLearner(4, 2)
    np.testing.assert_allclose(
        port("rl_policy_logits", j.get_weights(), obs),
        np.asarray(policy_logits(j.params, obs)), rtol=1e-6, atol=1e-7)
    j.set_weights(w)
    np.testing.assert_allclose(np.asarray(policy_logits(j.params, obs)),
                               port("rl_policy_logits", w, obs), rtol=1e-6,
                               atol=1e-7)


def test_vtrace_learner_math(port):
    rng = np.random.default_rng(2)
    batch = {
        "obs": rng.normal(size=(16, 4)).astype(np.float32),
        "next_obs": rng.normal(size=(16, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, 16).astype(np.int32),
        "logp": np.full(16, -0.7, dtype=np.float32),
        "rewards": rng.normal(size=16).astype(np.float32),
        "terminated": np.zeros(16, dtype=np.float32),
        "cut": np.zeros(16, dtype=np.float32),
    }
    (m,), _ = port("rl_learner", "VTraceLearner", (4, 2),
                   dict(hidden=(8,), seed=0),
                   calls=[("update", (batch,), {})])
    assert np.isfinite(m["total_loss"])
    assert np.isfinite(m["entropy"]) and m["entropy"] > 0


def _ring_batches():
    return [{
        "obs": np.arange(start, start + 4, dtype=np.float32)[:, None],
        "next_obs": np.zeros((4, 1), np.float32),
        "actions": np.zeros(4, np.int32),
        "rewards": np.zeros(4, np.float32),
        "terminated": np.zeros(4, np.float32),
    } for start in range(0, 12, 4)]


def test_replay_buffer_ring(port):
    n, (sample, again) = port("rl_replay", _ring_batches(), 8, 0, [64, 16])
    assert n == 8
    got = sample["obs"][:, 0]
    # oldest four (0..3) were overwritten by 8..11
    assert got.min() >= 4.0 and got.max() <= 11.0
    # the JAX package's buffer with the same seed draws the same rows
    buf = ReplayBuffer(capacity=8, seed=0)
    for b in _ring_batches():
        buf.add_batch(b)
    for got_, n_ in ((sample, 64), (again, 16)):
        want = buf.sample(n_)
        for k in ReplayBuffer.FIELDS:
            np.testing.assert_array_equal(got_[k], want[k])


def test_dqn_learner_fits_known_q(port):
    """On a deterministic 1-step MDP the learner must drive Q(s,a) → r."""
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(256, 2)).astype(np.float32)
    actions = rng.integers(0, 2, 256).astype(np.int32)
    rewards = (obs[np.arange(256), actions % 2] > 0).astype(np.float32)
    batch = {
        "obs": obs, "next_obs": obs, "actions": actions,
        "rewards": rewards, "terminated": np.ones(256, np.float32),
    }
    out, _ = port("rl_learner", "DQNLearner", (2, 2),
                  dict(hidden=(32,), lr=1e-2, gamma=0.0,
                       target_update_freq=10),
                  calls=[("update", (batch,), {})] * 201)
    first, last = out[0]["qf_loss"], out[-1]["qf_loss"]
    assert last < first * 0.2, (first, last)


def test_connector_pipeline(port):
    data = np.random.default_rng(0).normal(5.0, 3.0, size=(500, 4)).astype(
        np.float32)
    flat, norm = port("rl_connectors", np.ones((3, 2, 2), np.int64),
                      [data[i:i + 50] for i in range(0, 500, 50)])
    assert flat.shape == (3, 4)
    assert flat.dtype == np.float32
    assert float(flat[0, 0]) == 2.0


def test_normalize_obs_running_stats(port):
    rng = np.random.default_rng(0)
    data = rng.normal(5.0, 3.0, size=(500, 4)).astype(np.float32)
    _, outs = port("rl_connectors", np.ones((1, 1), np.float32),
                   [data[i:i + 50] for i in range(0, 500, 50)])
    out = outs[-1]
    # after enough samples the output is ~standardized
    assert abs(float(out.mean())) < 0.5
    assert 0.5 < float(out.std()) < 2.0


def test_sac_learner_update_shapes(port):
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.normal(size=(16, 3)).astype(np.float32),
        "next_obs": rng.normal(size=(16, 3)).astype(np.float32),
        "actions": np.tanh(rng.normal(size=(16, 1))).astype(np.float32),
        "rewards": rng.normal(size=16).astype(np.float32),
        "terminated": np.zeros(16, np.float32),
    }
    (m1, *_, m), w = port("rl_learner", "SACLearner", (3, 1),
                          dict(hidden=(32, 32), seed=0),
                          calls=[("update", (batch,), {})] * 5)
    assert np.isfinite(m["critic_loss"]) and np.isfinite(m["actor_loss"])
    assert m["alpha"] > 0
    # weights round-trip
    (m2,), _ = port("rl_learner", "SACLearner", (3, 1),
                    dict(hidden=(32, 32), seed=0), weights=w,
                    calls=[("update", (batch,), {})])
    assert np.isfinite(m2["critic_loss"])
    assert m1 != m


def test_cql_penalty_suppresses_ood_actions(port):
    """Unit: with a dataset that only ever takes action 0, the conservative
    penalty must drive Q(s, 1) below Q(s, 0) even though action 1's TD
    target would otherwise look attractive."""
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(512, 4)).astype(np.float32)
    batch = {
        "obs": obs,
        "action": np.zeros(512, np.int64),
        "reward": np.ones(512, np.float32),
        "next_obs": rng.normal(size=(512, 4)).astype(np.float32),
        "terminated": np.zeros(512, np.float32),
    }
    _, w = port("rl_learner", "CQLLearner", (4, 2),
                dict(hidden=(32,), lr=1e-2, cql_alpha=2.0,
                     target_update_freq=50, seed=1),
                calls=[("update", (batch,), {})] * 60)
    q = port("rl_mlp_apply", w["q1"], batch["obs"])
    assert (q[:, 0] > q[:, 1]).mean() > 0.95, q[:5]
