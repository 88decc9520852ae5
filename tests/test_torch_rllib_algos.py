"""The port's rllib algorithms (``ray_tpu_torch.rllib``: the env runners,
PPO, IMPALA, APPO, DQN, SAC, BC, CQL and MultiAgentPPO) held to the JAX
package's in tier-1, on the CPU.

- The runners: both packages' ``EnvRunner`` and ``MultiAgentEnvRunner``,
  built in process (``_cls``) from one seed and the same numpy weights,
  emit the same batches: observations, actions, rewards and terminations
  equal; log-probs, advantages and returns within 1e-5. SAC's continuous
  actions carry the forward's rounding into Pendulum's dynamics, so there
  everything but the terminations agrees to 1e-5.
- One iteration: ``PPO.train()``, ``DQN.train()`` and
  ``MultiAgentPPO.train()`` from JAX's initial weights on a cluster of
  each package give weights and metrics within 1e-5 of JAX's. PPO's
  minibatch is its whole batch, so ``jax.random``'s shuffle only reorders
  a mean; DQN's replay draws are numpy's in both.
- IMPALA, APPO and SAC harvest in arrival order or draw with
  ``jax.random``: they run one iteration with JAX's metric keys.
- Checkpoints written by either package load in the other; the config
  errors, ``__all__`` and BC / CQL from a port Dataset match JAX's.

The port's side runs in a spawned child (``_port_proc``) with its own
cluster; the JAX package's cluster runs in the pytest worker. The
learning thresholds are the ``mid`` tier's
(``test_torch_rllib_learning.py``)."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as rtd
import ray_tpu.rllib as jr
from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib.dqn import DQNLearner
from ray_tpu.rllib.learner import PPOLearner
from ray_tpu.rllib.sac import SACLearner

from _port_proc import spawn

sys.path.insert(0, os.path.dirname(__file__))
import _rl_envs  # noqa: E402

cloudpickle.register_pickle_by_value(_rl_envs)

TOL = 1e-5
CPUS = 8


@pytest.fixture(scope="module")
def port():
    with spawn() as call:
        call("rl_start", CPUS)
        yield call


@pytest.fixture(scope="module")
def jax_cluster():
    ray_tpu.init(num_cpus=CPUS)
    yield
    ray_tpu.shutdown()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _assert_close_trees(got, want, tol=TOL):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


EXACT = ("obs", "next_obs", "actions", "rewards", "terminated", "cut")


def _assert_same_batch(got, want, exact=EXACT):
    assert sorted(got) == sorted(want)
    for k in want:
        if k in exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


def _assert_same_outputs(got, want, exact=EXACT):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            _assert_same_batch(g, w, exact)
        elif exact is EXACT or isinstance(w, tuple):  # or a raised error
            assert g == w
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


# -- the env runners -----------------------------------------------------------


def _run_jax_runner(cls, args, kwargs, weights, calls, connectors=()):
    kwargs = dict(kwargs)
    if connectors:
        kwargs["env_to_module"] = jconn.ConnectorPipeline(
            [getattr(jconn, n)() for n in connectors])
    r = cls._cls(*args, **kwargs)
    r.set_weights(weights)
    out = []
    for name, a, kw in calls:
        try:
            out.append(getattr(r, name)(*a, **kw))
        except Exception as e:
            out.append(("raised", type(e).__name__, str(e)))
    return out


def _calls(*names, steps=64):
    table = {"sample": ("sample", (steps,), {}),
             "sample_raw": ("sample_raw", (steps,), {}),
             "returns": ("episode_returns", (), {}),
             "explore": ("set_exploration", (0.3,), {})}
    return [table[n] for n in names]


RUNNER_CASES = {
    # policy kind, env, the learner whose weights it reads, calls
    "categorical": ("categorical", "CartPole-v1",
                    lambda: PPOLearner(4, 2).get_weights(),
                    _calls("sample", "sample_raw", "sample", "returns"), ()),
    "epsilon_greedy": ("epsilon_greedy", "CartPole-v1",
                       lambda: DQNLearner(4, 2).get_weights(),
                       _calls("explore", "sample_raw", "sample", "returns"),
                       ()),
    "squashed_gaussian": ("squashed_gaussian", "Pendulum-v1",
                          lambda: {"actor": SACLearner(
                              3, 1, hidden=(32, 32)).get_weights()["actor"]},
                          _calls("sample_raw", "sample", "returns",
                                 steps=250), ()),
    "connectors": ("categorical", "CartPole-v1",
                   lambda: PPOLearner(4, 2).get_weights(),
                   _calls("sample", "sample_raw", "returns"),
                   ("FlattenObs", "NormalizeObs")),
}


@pytest.mark.parametrize("case", list(RUNNER_CASES))
def test_env_runner_matches_jax(port, case):
    kind, env, weights, calls, conns = RUNNER_CASES[case]
    w = weights()
    kwargs = dict(seed=1000, policy_kind=kind)
    want = _run_jax_runner(jr.EnvRunner, (env,), kwargs, w, calls, conns)
    got = port("rl_runner", "EnvRunner", (env,), kwargs, w, calls, conns)
    # a continuous action carries the forward's rounding (~1e-7) into the
    # env's dynamics: its trajectory agrees to 1e-5, not bit for bit
    _assert_same_outputs(got, want, EXACT if kind != "squashed_gaussian"
                         else ("terminated", "cut"))
    if kind == "squashed_gaussian":
        assert want[1][0] == "raised"  # sample() is the discrete path
    assert any(isinstance(x, list) and x for x in want), "no episode ended"


MAPPINGS = {"independent": ({"a0": {}, "a1": {}}, {}),
            "shared": ({"shared": {}}, {"a0": "shared", "a1": "shared"})}


def _ma_weights(policies):
    return {pid: PPOLearner(2, 2, hidden=(32, 32), seed=101 * i)
            .get_weights() for i, pid in enumerate(sorted(policies))}


@pytest.mark.parametrize("mapping", list(MAPPINGS))
def test_multi_agent_runner_matches_jax(port, mapping):
    policies, pmap = MAPPINGS[mapping]
    w = _ma_weights(policies)
    blob = cloudpickle.dumps(_rl_envs.make_matching_env)
    kwargs = dict(seed=1000, policy_mapping=pmap)
    calls = [("sample", (50,), {}), ("sample", (30,), {}),
             ("episode_returns", (), {})]
    want = _run_jax_runner(jr.MultiAgentEnvRunner, (blob,), kwargs, w,
                           calls)
    got = port("rl_runner", "MultiAgentEnvRunner", (blob,), kwargs, w,
               calls)
    assert len(got) == len(want)
    for g, wt in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(wt) == sorted(policies)
        for pid in wt:
            _assert_same_batch(g[pid], wt[pid])
    assert got[2] == want[2] and want[2]


# -- one iteration against JAX's -----------------------------------------------


def _jax_config(kind, builder, env_maker=None, rows=None, offline=None):
    cfg = getattr(jr, f"{kind}Config")()
    if env_maker is not None:
        cfg.environment(cloudpickle.loads(env_maker))
    if rows is not None:
        cfg.offline_data(rtd.from_items(rows, parallelism=4),
                         **(offline or {}))
    for name, a, kw in builder:
        getattr(cfg, name)(*a, **kw)
    return cfg


def _jax_algo(kind, builder, iters=1, weights=None, restore=None,
              save=None, on_start=None, **cfg_kw):
    """Build ``kind`` of the JAX package, restore or set its weights, call
    ``on_start`` with them, train ``iters`` iterations and save: the
    starting weights, the results and the final weights."""
    algo = _jax_config(kind, builder, **cfg_kw).build()
    try:
        if restore is not None:
            algo.restore_checkpoint(restore)
        elif weights is not None:
            algo.set_weights(weights)
        w0 = algo.get_weights()
        if on_start is not None:
            on_start(w0)
        results = [algo.train() for _ in range(iters)]
        if save is not None:
            algo.save_checkpoint(save)
        return w0, results, algo.get_weights()
    finally:
        if hasattr(algo, "stop"):
            algo.stop()


def _env(name):
    return ("environment", (name,), {})


def _runners(n, frag):
    return ("env_runners", (), dict(num_env_runners=n,
                                    rollout_fragment_length=frag))


def _training(**kw):
    return ("training", (), kw)


def _ma_builder(mapping):
    policies, pmap = MAPPINGS[mapping]
    spec = {"obs_dim": 2, "num_actions": 2, "hidden": (32, 32),
            # one minibatch of the whole batch: the shuffle drops out
            "minibatch_size": 1 << 20}
    return [("multi_agent", (), dict(
        policies={pid: dict(spec) for pid in policies},
        policy_mapping=pmap)), _runners(2, 50), _training(lr=3e-3)]


ITERATION_CASES = {
    "ppo": ("PPO", [_env("CartPole-v1"), _runners(2, 64),
                    _training(lr=3e-3, minibatch_size=128,
                              entropy_coeff=0.01)], {}),
    "dqn": ("DQN", [_env("CartPole-v1"), _runners(2, 64),
                    _training(lr=1e-3, learning_starts=64,
                              num_updates_per_iter=8, train_batch_size=32,
                              target_update_freq=4, hidden=[32, 32])], {}),
    "multi_agent_independent": ("MultiAgentPPO", _ma_builder("independent"),
                                "env"),
    "multi_agent_shared": ("MultiAgentPPO", _ma_builder("shared"), "env"),
}


def _cfg_kw(extra):
    if extra == "env":
        return {"env_maker": cloudpickle.dumps(_rl_envs.make_matching_env)}
    return dict(extra)


@pytest.mark.parametrize("case", list(ITERATION_CASES))
def test_one_iteration_matches_jax(port, jax_cluster, case):
    kind, builder, extra = ITERATION_CASES[case]
    got = []
    with ThreadPoolExecutor(1) as pool:  # the two clusters side by side
        w0, (want,), want_w = _jax_algo(
            kind, builder, on_start=lambda w: got.append(pool.submit(
                port, "rl_algo", kind, builder, weights=w,
                **_cfg_kw(extra))), **_cfg_kw(extra))
        got = got[0].result()
    (res,) = got["results"]
    _assert_close_trees(got["weights"], want_w)
    assert sorted(res) == sorted(want)
    for k, v in want.items():
        if k.endswith("per_s"):
            continue
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(res[k]), k
        else:
            np.testing.assert_allclose(res[k], v, rtol=TOL, atol=TOL,
                                       err_msg=k)
    # the update moved the weights: the comparison is not of w0 twice
    assert max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(want_w), _leaves(w0))) > 1e-4


ASYNC_CASES = {
    "impala": ("IMPALA", [_env("CartPole-v1"), _runners(2, 32),
                          _training(train_batches_per_iteration=3)]),
    "appo": ("APPO", [_env("CartPole-v1"), _runners(2, 32),
                      _training(train_batches_per_iteration=3,
                                target_update_freq=2)]),
    "sac": ("SAC", [_env("Pendulum-v1"), _runners(1, 64),
                    _training(learning_starts=32, num_updates_per_iter=4,
                              train_batch_size=32, hidden=[32, 32])]),
}


@pytest.mark.parametrize("case", list(ASYNC_CASES))
def test_async_and_sac_iteration_keys_match_jax(port, jax_cluster, case):
    """One iteration of each algorithm whose run cannot be held step for
    step: the same metric keys and sampled steps as JAX's."""
    kind, builder = ASYNC_CASES[case]
    with ThreadPoolExecutor(1) as pool:  # the two clusters side by side
        got = pool.submit(port, "rl_algo", kind, builder)
        _, (want,), _ = _jax_algo(kind, builder)
        (got,) = got.result()["results"]
    assert sorted(got) == sorted(want)
    assert got["num_env_steps_sampled"] == want["num_env_steps_sampled"]
    assert all(np.isfinite(v) for k, v in got.items()
               if k != "episode_return_mean")


# -- checkpoints -----------------------------------------------------------------


CKPT_CASES = {
    "ppo": ("PPO", [_env("CartPole-v1"), _runners(1, 32)]),
    "dqn": ("DQN", [_env("CartPole-v1"), _runners(1, 32),
                    _training(hidden=[32, 32])]),
}


@pytest.mark.parametrize("case", list(CKPT_CASES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_in_the_other_package(port, jax_cluster, tmp_path,
                                               case, direction):
    kind, builder = CKPT_CASES[case]
    path = str(tmp_path / "algo.pkl")
    if direction == "jax_to_port":
        _, _, saved = _jax_algo(kind, builder, iters=0, save=path)
        loaded = port("rl_algo", kind, builder, iters=0,
                      restore=path)["weights"]
    else:
        saved = port("rl_algo", kind, builder, iters=0, save=path)["weights"]
        _, _, loaded = _jax_algo(kind, builder, iters=0, restore=path)
    _assert_close_trees(loaded, saved, tol=0.0)


# -- the rest of the surface ---------------------------------------------------


def test_rllib_exports_match_jax(port):
    names, public = port("rl_names")
    assert names == jr.__all__
    assert set(jr.__all__) <= set(public)
    for extra in ("APPO", "APPOConfig", "CQL", "CQLConfig", "CQLLearner"):
        assert extra in public and hasattr(jr, extra)


ERROR_CASES = {
    # name: (kind, builder, keywords), built with no env / no dataset
    **{k: (k, [], {}) for k in ("PPO", "IMPALA", "APPO", "DQN", "SAC",
                                "BC", "CQL", "MultiAgentPPO")},
}


def test_config_errors_match_jax(port):
    want = {}
    for name, (kind, builder, kw) in ERROR_CASES.items():
        with pytest.raises(ValueError) as e:
            _jax_config(kind, builder, **kw).build()
        want[name] = ("ValueError", str(e.value))
    got = port("rl_build_errors", ERROR_CASES)
    got.pop("cuda_available")
    assert got == want


OFFLINE = {
    "BC": ([_training(lr=1e-2, train_batch_size=64, hidden=[16])],
           dict(obs_column="obs", action_column="action")),
    "CQL": ([_training(lr=1e-2, train_batch_size=64, hidden=[16],
                       target_update_freq=4)], None),
}


@pytest.mark.parametrize("kind", list(OFFLINE))
def test_offline_algorithms_train_on_a_port_dataset(port, jax_cluster, kind):
    """BC and CQL read a ``ray_tpu_torch.data`` Dataset: JAX's metric keys,
    every row trained once an iteration, and greedy actions that follow
    the matching game's expert on held-out observations."""
    builder, offline = OFFLINE[kind]
    rows = _rl_envs.matching_expert_rows(256, seed=0,
                                         eps=0.0 if kind == "BC" else 0.2)
    obs, expert = _rl_envs.held_out_observations(16, seed=7)
    got = port("rl_algo", kind, builder, iters=3, rows=rows,
               offline=offline, evaluate=list(obs))
    algo = _jax_config(kind, builder, rows=rows, offline=offline).build()
    want = algo.train()
    for res in got["results"]:
        assert sorted(res) == sorted(want)
        assert res["num_samples_trained"] == want["num_samples_trained"] \
            == len(rows)
    assert np.array_equal(got["actions"], expert)
    w = got["weights"]
    assert all(isinstance(x, np.ndarray) for x in _leaves(w))


def test_algorithm_learners_default_to_cuda(port):
    """With no ``training(device=...)`` every algorithm's learner asks for
    CUDA, which this machine lacks: building raises as the learners do."""
    rows = _rl_envs.matching_expert_rows(16)
    env = cloudpickle.dumps(_rl_envs.make_matching_env)
    cases = {
        "PPO": ("PPO", [_env("CartPole-v1")], {"device": None}),
        "IMPALA": ("IMPALA", [_env("CartPole-v1")], {"device": None}),
        "APPO": ("APPO", [_env("CartPole-v1")], {"device": None}),
        "DQN": ("DQN", [_env("CartPole-v1")], {"device": None}),
        "SAC": ("SAC", [_env("Pendulum-v1")], {"device": None}),
        "BC": ("BC", [], {"device": None, "rows": rows}),
        "CQL": ("CQL", [], {"device": None, "rows": rows}),
        "MultiAgentPPO": ("MultiAgentPPO", _ma_builder("shared")[:1],
                          {"device": None, "env_maker": env}),
    }
    got = port("rl_build_errors", cases)
    if got.pop("cuda_available"):
        pytest.skip("this machine has CUDA: the default device is valid")
    for name in cases:
        assert got[name] is not None and got[name][0] == "RuntimeError" \
            and "CUDA" in got[name][1], (name, got[name])
