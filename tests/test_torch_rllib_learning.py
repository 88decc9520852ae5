"""The JAX package's rllib learning tests on the port, at their thresholds
and in their tier (``mid``: run with ``-m mid``; tier-1 skips them, see
``conftest.py``): PPO and IMPALA on CartPole (``test_rllib.py``), DQN on
CartPole with and without a connector pipeline (``test_rllib_dqn.py``),
SAC on Pendulum and BC from a Dataset (``test_rllib_sac_bc.py``), APPO
and CQL from offline data (``test_rllib_appo_cql.py``), and MultiAgentPPO
with independent and shared policies (``test_rllib_multi_agent.py``).

The algorithms run in a spawned child (``_port_proc``) on a cluster of the
port, their learners on the CPU; the thresholds are checked here.
``test_torch_rllib_algos.py`` holds the runners and one iteration to JAX's
in tier-1."""

import os
import sys

import cloudpickle
import numpy as np
import pytest

from _port_proc import spawn

sys.path.insert(0, os.path.dirname(__file__))
import _rl_envs  # noqa: E402

cloudpickle.register_pickle_by_value(_rl_envs)

pytestmark = pytest.mark.mid


@pytest.fixture(scope="module")
def port():
    with spawn(timeout=600.0) as call:
        call("rl_start", 8)
        yield call


def _finite_returns(results):
    return [r["episode_return_mean"] for r in results
            if np.isfinite(r["episode_return_mean"])]


def _env(name):
    return ("environment", (name,), {})


def _runners(n, frag, **kw):
    return ("env_runners", (), dict(num_env_runners=n,
                                    rollout_fragment_length=frag, **kw))


def _training(**kw):
    return ("training", (), kw)


# -- test_rllib.py -------------------------------------------------------------


def test_ppo_cartpole_improves(port, tmp_path):
    builder = [_env("CartPole-v1"), _runners(2, 256),
               _training(lr=3e-3, num_epochs=4, minibatch_size=128,
                         entropy_coeff=0.01)]
    path = str(tmp_path / "ppo.pkl")
    out = port("rl_algo", "PPO", builder, iters=8, save=path)
    results = out["results"]
    assert results[-1]["training_iteration"] == 8
    assert results[-1]["num_env_steps_sampled"] == 512
    early, late = _finite_returns(results[:2]), _finite_returns(results[-3:])
    assert late, "no completed episodes late in training"
    # CartPole random policy averages ~20; PPO should clearly improve
    assert np.mean(late) > np.mean(early) or np.mean(late) > 50, (
        f"no learning: early={early} late={late}")
    # checkpoint round-trip preserves the weights
    back = port("rl_algo", "PPO", builder[:2], iters=0, restore=path)
    for a, b in zip(_rl_leaves(back["weights"]), _rl_leaves(out["weights"])):
        np.testing.assert_array_equal(a, b)


def _rl_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _rl_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _rl_leaves(v)]
    return [tree]


def test_impala_learns_cartpole(port):
    out = port("rl_algo", "IMPALA", [
        _env("CartPole-v1"), _runners(2, 256),
        _training(lr=5e-4, entropy_coeff=0.01,
                  train_batches_per_iteration=6)],
        iters=10_000, stop_above=60, deadline_s=120)
    first, results = out["results"][0], out["results"][1:]
    assert first["num_env_steps_sampled"] > 0
    best = max(_finite_returns(results), default=-np.inf)
    # CartPole random policy averages ~20; async V-trace training must
    # show clear improvement inside the budget
    assert best > 60, f"no learning progress: best={best}"


# -- test_rllib_dqn.py ---------------------------------------------------------


def test_dqn_cartpole_improves(port, tmp_path):
    builder = [_env("CartPole-v1"), _runners(2, 256),
               _training(lr=1e-3, train_batch_size=64,
                         num_updates_per_iter=96, learning_starts=500,
                         target_update_freq=150, epsilon_timesteps=4000,
                         hidden=[128, 128])]
    path = str(tmp_path / "dqn.pkl")
    results = port("rl_algo", "DQN", builder, iters=12, save=path)["results"]
    assert results[-1]["training_iteration"] == 12
    assert results[-1]["replay_buffer_size"] > 1000
    assert results[-1]["epsilon"] < 0.2
    early, late = _finite_returns(results[:3]), _finite_returns(results[-3:])
    assert late, "no completed episodes late in training"
    assert np.mean(late) > np.mean(early) or np.mean(late) > 60, (
        f"no learning: early={early} late={late}")
    port("rl_algo", "DQN", builder, iters=0, restore=path)


def test_dqn_with_connector_pipeline(port):
    """env_to_module connectors apply during sampling (obs reach the
    learner transformed)."""
    (out,) = port("rl_algo", "DQN", [
        _env("CartPole-v1"),
        _runners(1, 64, env_to_module=("FlattenObs",)),
        _training(learning_starts=32, num_updates_per_iter=4)])["results"]
    assert out["num_env_steps_sampled"] == 64
    assert np.isfinite(out.get("qf_loss", 0.0))


# -- test_rllib_sac_bc.py ------------------------------------------------------


def test_sac_pendulum_improves(port, tmp_path):
    """Pendulum SAC reaches JAX's return threshold (random policy:
    ~-1200..-1600)."""
    builder = [_env("Pendulum-v1"), _runners(2, 250),
               _training(actor_lr=1e-3, critic_lr=1e-3, tau=0.02,
                         train_batch_size=128, num_updates_per_iter=150,
                         learning_starts=500, hidden=[64, 64])]
    path = str(tmp_path / "sac.pkl")
    results = port("rl_algo", "SAC", builder, iters=16, save=path)["results"]
    assert results[-1]["training_iteration"] == 16
    assert results[-1]["replay_buffer_size"] > 2000
    early, late = _finite_returns(results[:3]), _finite_returns(results[-3:])
    assert late, "no completed episodes late in training"
    assert np.mean(late) > np.mean(early) + 200 or np.mean(late) > -700, (
        f"no learning: early={early} late={late}")
    # entropy temperature adapted away from its init
    assert results[-1]["alpha"] != pytest.approx(1.0)
    port("rl_algo", "SAC", builder, iters=0, restore=path)


def _cartpole_expert(obs):
    """Scripted expert: push in the direction the pole is falling."""
    return int(obs[2] + 0.5 * obs[3] > 0)


def test_bc_clones_expert_from_dataset(port):
    """Offline BC reads {obs, action} rows from a ``ray_tpu_torch.data``
    Dataset and clones a scripted CartPole expert well enough to hit its
    return."""
    import gymnasium as gym

    env = gym.make("CartPole-v1")
    rows = []
    obs, _ = env.reset(seed=0)
    for _ in range(4000):
        a = _cartpole_expert(obs)
        rows.append({"obs": np.asarray(obs, np.float32), "action": a})
        obs, _r, term, trunc, _ = env.step(a)
        if term or trunc:
            obs, _ = env.reset()
    env.close()
    out = port("rl_algo", "BC", [
        _env("CartPole-v1"),
        _training(lr=1e-3, train_batch_size=256, hidden=[64, 64])],
        iters=10, rows=rows,
        offline=dict(obs_column="obs", action_column="action"), episodes=3)
    losses = [r["loss"] for r in out["results"]]
    assert losses[-1] < losses[0], losses
    # the scripted expert scores ~120-200; the clone must be in its league
    # (a random policy scores ~20)
    assert out["evaluate"]["episode_return_mean"] > 80, out["evaluate"]


# -- test_rllib_appo_cql.py ----------------------------------------------------


def test_appo_learner_improves_cartpole(port):
    """APPO must learn CartPole through the async IMPALA pipeline with the
    clipped-surrogate/V-trace loss."""
    results = port("rl_algo", "APPO", [
        _env("CartPole-v1"), _runners(2, 256),
        _training(lr=3e-3, entropy_coeff=0.01, clip_param=0.3,
                  train_batches_per_iteration=8)],
        iters=15, stop_above=120)["results"]
    best = max(_finite_returns(results), default=-np.inf)
    assert best > 120, f"APPO never learned: best={best}"
    assert results[-1]["env_steps_per_s"] > 0


def _collect_transitions(n, seed=0, eps=0.3):
    """Mixed-quality CartPole transitions (expert + noise) — the offline
    regime CQL is built for."""
    import gymnasium as gym

    rng = np.random.default_rng(seed)
    env = gym.make("CartPole-v1")
    rows = []
    obs, _ = env.reset(seed=seed)
    for _ in range(n):
        # angle+velocity balance heuristic, epsilon-corrupted
        a = int(obs[2] + 0.5 * obs[3] > 0)
        if rng.random() < eps:
            a = int(rng.integers(2))
        nobs, r, term, trunc, _ = env.step(a)
        rows.append({"obs": np.asarray(obs, np.float32), "action": a,
                     "reward": float(r),
                     "next_obs": np.asarray(nobs, np.float32),
                     "terminated": float(term)})
        obs = nobs
        if term or trunc:
            obs, _ = env.reset()
    env.close()
    return rows


def test_cql_learns_policy_from_offline_data(port):
    """CQL trains a usable greedy policy purely from logged transitions,
    and the conservative penalty actually shrinks over training."""
    out = port("rl_algo", "CQL", [
        _env("CartPole-v1"),
        _training(lr=1e-3, cql_alpha=0.5, train_batch_size=256,
                  hidden=[64, 64], target_update_freq=100)],
        iters=8, rows=_collect_transitions(6000), episodes=3)
    m0, m = out["results"][0], out["results"][-1]
    assert m["cql_penalty"] < m0["cql_penalty"], (m0, m)
    # random scores ~20; the heuristic behind the data ~100+
    assert out["evaluate"]["episode_return_mean"] > 60, out["evaluate"]


# -- test_rllib_multi_agent.py -------------------------------------------------


def _run_multi_agent(port, policies, mapping, iters=12):
    return port("rl_algo", "MultiAgentPPO", [
        ("multi_agent", (), dict(policies=policies, policy_mapping=mapping)),
        _runners(2, 200), _training(lr=3e-3)], iters=iters,
        env_maker=cloudpickle.dumps(_rl_envs.make_matching_env))["results"]


def test_independent_policies_learn(port):
    spec = {"obs_dim": 2, "num_actions": 2, "hidden": (32, 32)}
    results = _run_multi_agent(port, {"a0": dict(spec), "a1": dict(spec)},
                               mapping={})
    late = _finite_returns(results[-3:])
    assert late, "no completed episodes"
    # optimal 40/episode (total across agents); random ~10
    assert np.mean(late) > 25, f"no coordination learned: {late}"
    # per-policy metrics surfaced
    assert any(k.startswith("a0/") for k in results[-1])
    assert any(k.startswith("a1/") for k in results[-1])


def test_parameter_shared_policy_learns(port):
    results = _run_multi_agent(
        port, {"shared": {"obs_dim": 2, "num_actions": 2,
                          "hidden": (32, 32)}},
        mapping={"a0": "shared", "a1": "shared"})
    late = _finite_returns(results[-3:])
    assert late and np.mean(late) > 25, f"shared policy failed: {late}"
    assert any(k.startswith("shared/") for k in results[-1])
