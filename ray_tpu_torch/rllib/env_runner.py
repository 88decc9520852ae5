"""EnvRunner actor: collects rollouts with the current policy. The port's
counterpart of ``ray_tpu/rllib/env_runner.py``.

Reference surface: rllib/env/single_agent_env_runner.py:68 (sample(), env
lifecycle, weight sync) + env_runner_group.py:70 (the actor gang). Policy
inference here is PyTorch on the runner's CPU (``RUNNER_DEVICE``): the
runner holds no GPU lease and never touches CUDA, so a runner costs no
CUDA context on the node's card. Weights arrive as numpy nests from the
learner, as in the JAX package; the runner's draws (``np.random``) and env
seeding are the JAX package's, so the same weights give the same batches.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch

# policy inference stays on the host: a runner must not create a CUDA
# context (~0.5 GB of the card per runner process)
RUNNER_DEVICE = "cpu"


def host_params(weights: Any) -> Any:
    """A numpy weight nest as torch tensors on ``RUNNER_DEVICE``."""
    from ray_tpu_torch.models.convert import params_from_jax

    return params_from_jax(weights, RUNNER_DEVICE)


def host_forward(fn, params: Any, obs: np.ndarray) -> np.ndarray:
    """``fn(params, obs)`` (a learner's ``mlp_apply``, ``policy_logits``
    or ``value_fn``) on a numpy batch, as a float32 numpy array."""
    import torch

    with torch.no_grad():
        x = torch.from_numpy(np.ascontiguousarray(obs, np.float32))
        return fn(params, x).numpy()


@ray_tpu_torch.remote
class EnvRunner:
    """One rollout worker (reference: SingleAgentEnvRunner)."""

    def __init__(self, env_name: str, *, seed: int = 0,
                 env_config: Optional[dict] = None,
                 gamma: float = 0.99, gae_lambda: float = 0.95,
                 policy_kind: str = "categorical",
                 env_to_module: Optional[Any] = None,
                 module_to_env: Optional[Any] = None):
        import gymnasium as gym

        self.env = gym.make(env_name, **(env_config or {}))
        self.obs, _ = self.env.reset(seed=seed)
        self.rng = np.random.default_rng(seed)
        self.gamma = gamma
        self.lam = gae_lambda
        self.weights = None
        self._params = None  # the weights as CPU tensors
        # "categorical" (actor-critic heads) or "epsilon_greedy" (Q head)
        self.policy_kind = policy_kind
        self.epsilon = 0.0
        # connector pipelines (reference: ConnectorV2 env_to_module /
        # module_to_env); processed observations are what both the policy
        # AND the emitted batches see
        self.env_to_module = env_to_module
        self.module_to_env = module_to_env
        self._episode_return = 0.0
        self._completed_returns: List[float] = []

    def set_weights(self, weights: Any) -> bool:
        self.weights = weights
        self._params = host_params(weights)
        return True

    def set_exploration(self, epsilon: float) -> bool:
        self.epsilon = float(epsilon)
        return True

    def _preprocess(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if self.env_to_module is None:
            return obs
        return self.env_to_module({"obs": obs[None]})["obs"][0]

    def _postprocess_action(self, action):
        if self.module_to_env is None:
            return action
        return self.module_to_env(
            {"actions": np.asarray([action])})["actions"][0]

    def _env_action(self, action):
        """Map a policy action into the env's action space (squashed
        continuous policies emit tanh-space [-1, 1] vectors)."""
        if self.policy_kind != "squashed_gaussian":
            return action
        space = self.env.action_space
        low = np.asarray(space.low, np.float32)
        high = np.asarray(space.high, np.float32)
        return (low + (np.asarray(action) + 1.0) * 0.5 * (high - low)).astype(
            np.float32)

    def _policy(self, obs: np.ndarray):
        if self.policy_kind == "squashed_gaussian":
            # SAC actor: MLP -> (mu, log_std), tanh-squashed sample
            # (reference: sac.py action sampling); buffers store the
            # tanh-space action the critics are trained on
            from ray_tpu_torch.rllib.learner import (LOG_STD_MAX,
                                                     LOG_STD_MIN, mlp_apply)

            out = host_forward(mlp_apply, self._params["actor"], obs[None])[0]
            d = out.shape[-1] // 2
            mu = out[:d]
            log_std = np.clip(out[d:], LOG_STD_MIN, LOG_STD_MAX)
            u = mu + np.exp(log_std) * self.rng.standard_normal(d)
            return np.tanh(u).astype(np.float32), 0.0, 0.0
        if self.policy_kind == "epsilon_greedy":
            from ray_tpu_torch.rllib.learner import mlp_apply

            q = host_forward(mlp_apply, self._params["q"], obs[None])[0]
            if self.rng.random() < self.epsilon:
                action = int(self.rng.integers(len(q)))
            else:
                action = int(np.argmax(q))
            return action, 0.0, float(q[action])
        from ray_tpu_torch.rllib.learner import policy_logits, value_fn

        logits = host_forward(policy_logits, self._params, obs[None])[0]
        logits = logits - logits.max()
        p = np.exp(logits)
        p /= p.sum()
        action = int(self.rng.choice(len(p), p=p))
        logp = float(np.log(p[action] + 1e-12))
        value = float(host_forward(value_fn, self._params, obs[None])[0])
        return action, logp, value

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect num_steps transitions; returns a batch with GAE
        advantages/returns computed at the boundary (reference:
        postprocessing in the env runner's connector pipeline)."""
        from ray_tpu_torch.rllib.learner import compute_gae, value_fn

        assert self.weights is not None, "set_weights before sample"
        if self.policy_kind == "squashed_gaussian":
            raise ValueError(
                "continuous policies use sample_raw (replay-based learners);"
                " the GAE path has no continuous log-prob support yet")
        probe = self._preprocess(self.obs)
        obs_buf = np.zeros((num_steps, *probe.shape), dtype=np.float32)
        act_buf = np.zeros(num_steps, dtype=np.int32)
        logp_buf = np.zeros(num_steps, dtype=np.float32)
        rew_buf = np.zeros(num_steps, dtype=np.float32)
        term_buf = np.zeros(num_steps, dtype=np.float32)
        cut_buf = np.zeros(num_steps, dtype=np.float32)
        val_buf = np.zeros(num_steps, dtype=np.float32)
        next_val_buf = np.zeros(num_steps, dtype=np.float32)

        def _value_p(pobs) -> float:
            return float(host_forward(value_fn, self._params, pobs[None])[0])

        # preprocess each raw frame exactly ONCE and carry it forward:
        # stateful connectors (NormalizeObs) advance running statistics per
        # call, so re-preprocessing would make next_obs[t] != obs[t+1]
        pobs = probe
        for t in range(num_steps):
            action, logp, value = self._policy(pobs)
            nxt, reward, terminated, truncated, _ = self.env.step(
                self._postprocess_action(action))
            pnxt = self._preprocess(nxt)
            obs_buf[t] = pobs
            act_buf[t] = action
            logp_buf[t] = logp
            rew_buf[t] = reward
            val_buf[t] = value
            done = terminated or truncated
            term_buf[t] = float(terminated)
            cut_buf[t] = float(done)
            if done:
                # bootstrap from the TRUE successor: on truncation that is
                # the pre-reset final observation, never the next episode's
                # start (interior steps are backfilled from val_buf below)
                next_val_buf[t] = 0.0 if terminated else _value_p(pnxt)
            self._episode_return += float(reward)
            if done:
                self._completed_returns.append(self._episode_return)
                self._episode_return = 0.0
                self.obs, _ = self.env.reset()
                pobs = self._preprocess(self.obs)
            else:
                self.obs = nxt
                pobs = pnxt
        interior = cut_buf[:-1] == 0.0
        next_val_buf[:-1][interior] = val_buf[1:][interior]
        if cut_buf[-1] == 0.0:
            next_val_buf[-1] = _value_p(pobs)
        adv, ret = compute_gae(
            rew_buf, val_buf, next_val_buf, term_buf, cut_buf,
            self.gamma, self.lam)
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "advantages": adv, "returns": ret,
        }

    def sample_raw(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect num_steps raw transitions for V-trace learners: no GAE —
        the learner computes values under its CURRENT policy and corrects
        off-policyness itself (reference: IMPALA env runners ship raw
        fragments; impala.py:526)."""
        assert self.weights is not None, "set_weights before sample"
        probe = self._preprocess(self.obs)
        obs_buf = np.zeros((num_steps, *probe.shape), dtype=np.float32)
        next_obs_buf = np.zeros_like(obs_buf)
        if self.policy_kind == "squashed_gaussian":
            act_dim = int(np.prod(self.env.action_space.shape))
            act_buf = np.zeros((num_steps, act_dim), dtype=np.float32)
        else:
            act_buf = np.zeros(num_steps, dtype=np.int32)
        logp_buf = np.zeros(num_steps, dtype=np.float32)
        rew_buf = np.zeros(num_steps, dtype=np.float32)
        term_buf = np.zeros(num_steps, dtype=np.float32)
        cut_buf = np.zeros(num_steps, dtype=np.float32)
        # single preprocess per frame, carried forward (see sample())
        pobs = probe
        for t in range(num_steps):
            action, logp, _ = self._policy(pobs)
            nxt, reward, terminated, truncated, _ = self.env.step(
                self._postprocess_action(self._env_action(action)))
            pnxt = self._preprocess(nxt)
            obs_buf[t] = pobs
            next_obs_buf[t] = pnxt  # pre-reset successor on episode end
            act_buf[t] = action
            logp_buf[t] = logp
            rew_buf[t] = reward
            done = terminated or truncated
            term_buf[t] = float(terminated)
            cut_buf[t] = float(done)
            self._episode_return += float(reward)
            if done:
                self._completed_returns.append(self._episode_return)
                self._episode_return = 0.0
                self.obs, _ = self.env.reset()
                pobs = self._preprocess(self.obs)
            else:
                self.obs = nxt
                pobs = pnxt
        return {
            "obs": obs_buf, "next_obs": next_obs_buf, "actions": act_buf,
            "logp": logp_buf, "rewards": rew_buf, "terminated": term_buf,
            "cut": cut_buf,
        }

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._completed_returns)
        if clear:
            self._completed_returns.clear()
        return out

    def ping(self) -> bool:
        return True
