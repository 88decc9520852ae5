"""Multi-agent RL: per-agent policies over dict-keyed environments.

Reference surface: rllib/env/multi_agent_env.py (MultiAgentEnv — dict
obs/rewards/terminations keyed by agent id), multi_agent_env_runner.py
(rollouts splitting per-agent experience), and the policy-mapping +
MultiRLModule machinery (core/rl_module/multi_rl_module.py): each agent
maps to a policy id, policies train independently on their own experience
(parameter sharing = mapping several agents to one policy).

Env protocol (the MultiAgentEnv parallel shape):
    reset(seed) -> ({agent: obs}, info)
    step({agent: action}) -> ({agent: obs}, {agent: rew},
                              {agent: terminated}, {agent: truncated}, info)
    agents: list of agent ids;
    observation/action spaces via obs_dim(agent) / num_actions(agent) or
    gymnasium-style spaces dicts.

The port's counterpart of ``ray_tpu/rllib/multi_agent.py``: the runners
infer on their CPU as ``EnvRunner`` does, and the per-policy learners run
on CUDA unless ``training(device="cpu")``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import host_forward, host_params


@ray_tpu_torch.remote
class MultiAgentEnvRunner:
    """One rollout worker over a multi-agent env: collects per-POLICY
    batches with GAE (reference: multi_agent_env_runner.py)."""

    def __init__(self, env_maker_blob: bytes, *, seed: int = 0,
                 gamma: float = 0.99, gae_lambda: float = 0.95,
                 policy_mapping: Optional[Dict[str, str]] = None):
        import cloudpickle

        self.env = cloudpickle.loads(env_maker_blob)()
        self.obs, _ = self.env.reset(seed=seed)
        self.rng = np.random.default_rng(seed)
        self.gamma = gamma
        self.lam = gae_lambda
        self.weights: Dict[str, Any] = {}  # policy id -> params
        self._params: Dict[str, Any] = {}  # the same, as CPU tensors
        self.mapping = dict(policy_mapping or {})
        self._episode_return = 0.0
        self._completed: List[float] = []

    def set_weights(self, weights: Dict[str, Any]) -> bool:
        self.weights = weights
        self._params = host_params(weights)
        return True

    def _policy_id(self, agent: str) -> str:
        return self.mapping.get(agent, agent)

    def _act(self, agent: str, obs):
        from ray_tpu_torch.rllib.learner import mlp_apply

        w = self._params[self._policy_id(agent)]
        pobs = np.asarray(obs, np.float32)
        logits = host_forward(mlp_apply, w["pi"], pobs[None])[0]
        logits = logits - logits.max()
        p = np.exp(logits)
        p /= p.sum()
        action = int(self.rng.choice(len(p), p=p))
        logp = float(np.log(p[action] + 1e-12))
        value = float(host_forward(mlp_apply, w["vf"], pobs[None])[0, 0])
        return action, logp, value

    def sample(self, num_steps: int) -> Dict[str, Dict[str, np.ndarray]]:
        """num_steps ENV steps; returns {policy_id: batch} carrying
        obs/actions/logp/advantages/returns for every transition of every
        agent mapped to that policy. Trajectories buffer PER (policy,
        agent): GAE's TD chain must never cross agents — interleaving a
        shared policy's agents would apply one gamma*lam per array element
        instead of per env step."""
        from ray_tpu_torch.rllib.learner import compute_gae, mlp_apply

        assert self.weights, "set_weights before sample"
        traj: Dict[tuple, Dict[str, list]] = {}

        def buf(pid, agent):
            return traj.setdefault((pid, agent), {
                "obs": [], "actions": [], "logp": [], "rewards": [],
                "values": [], "next_values": [], "terminated": [],
                "cut": [],
            })

        def vf(pid, obs):
            return float(host_forward(
                mlp_apply, self._params[pid]["vf"],
                np.asarray(obs, np.float32)[None])[0, 0])

        for _ in range(num_steps):
            acts, metas = {}, {}
            for agent, obs in self.obs.items():
                a, logp, v = self._act(agent, obs)
                acts[agent] = a
                metas[agent] = (np.asarray(obs, np.float32), a, logp, v)
            nxt, rews, terms, truncs, _ = self.env.step(acts)
            # episode over when EVERY agent is terminated-or-truncated
            # (RLlib's "__all__" semantics — `all(terms) or all(truncs)`
            # would miss mixed term/trunc endings and step a finished env)
            done = bool(metas) and all(
                bool(terms.get(a, False)) or bool(truncs.get(a, False))
                for a in metas)
            self._episode_return += float(sum(rews.values()))
            for agent, (pobs, a, logp, v) in metas.items():
                pid = self._policy_id(agent)
                b = buf(pid, agent)
                term = bool(terms.get(agent, False))
                cut = term or bool(truncs.get(agent, False)) or done
                # interior next_values are backfilled from the NEXT step's
                # value (see below); only boundaries pay an extra forward
                nv = 0.0
                if cut and not term and agent in nxt:
                    nv = vf(pid, nxt[agent])
                b["obs"].append(pobs)
                b["actions"].append(a)
                b["logp"].append(logp)
                b["rewards"].append(float(rews.get(agent, 0.0)))
                b["values"].append(v)
                b["next_values"].append(nv)
                b["terminated"].append(float(term))
                b["cut"].append(float(cut))
            if done:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                self.obs, _ = self.env.reset()
            else:
                self.obs = nxt
        per_policy: Dict[str, Dict[str, list]] = {}
        for (pid, agent), b in traj.items():
            val = np.asarray(b["values"], np.float32)
            nval = np.asarray(b["next_values"], np.float32)
            cut = np.asarray(b["cut"], np.float32)
            # backfill: within one (policy, agent) trajectory, an interior
            # step's next value IS the next step's value (env_runner.py's
            # pattern — no duplicate vf forwards on the hot path)
            interior = cut[:-1] == 0.0
            nval[:-1][interior] = val[1:][interior]
            if cut.size and cut[-1] == 0.0 and agent in self.obs:
                nval[-1] = vf(pid, self.obs[agent])
            adv, ret = compute_gae(
                np.asarray(b["rewards"], np.float32), val, nval,
                np.asarray(b["terminated"], np.float32), cut,
                self.gamma, self.lam)
            out_b = per_policy.setdefault(pid, {
                "obs": [], "actions": [], "logp": [],
                "advantages": [], "returns": [],
            })
            out_b["obs"].append(np.asarray(b["obs"], np.float32))
            out_b["actions"].append(np.asarray(b["actions"], np.int32))
            out_b["logp"].append(np.asarray(b["logp"], np.float32))
            out_b["advantages"].append(adv)
            out_b["returns"].append(ret)
        return {
            pid: {k: np.concatenate(v) for k, v in parts.items()}
            for pid, parts in per_policy.items()
        }

    def episode_returns(self, clear: bool = True) -> List[float]:
        out = list(self._completed)
        if clear:
            self._completed.clear()
        return out


class MultiAgentPPOConfig:
    """Builder config (reference: AlgorithmConfig.multi_agent(policies=...,
    policy_mapping_fn=...))."""

    def __init__(self):
        self.env_maker: Optional[Callable] = None
        self.policies: Dict[str, dict] = {}  # policy id -> spec dict
        self.policy_mapping: Dict[str, str] = {}
        self.num_env_runners = 2
        self.rollout_fragment_length = 128
        self.lr = 3e-4
        self.gamma = 0.99
        self.gae_lambda = 0.95
        self.seed = 0
        self.device = None  # the learner's: None is CUDA, "cpu" the CPU

    def environment(self, env_maker: Callable):
        """env_maker: zero-arg callable returning a MultiAgentEnv-shaped
        object (picklable by cloudpickle)."""
        self.env_maker = env_maker
        return self

    def multi_agent(self, *, policies: Dict[str, dict],
                    policy_mapping: Optional[Dict[str, str]] = None):
        """policies: {policy_id: {"obs_dim": int, "num_actions": int,
        ...PPOLearner kwargs}}; policy_mapping: agent id -> policy id
        (unmapped agents use their own id — one policy per agent).
        Parameter sharing = several agents mapping to one policy id."""
        self.policies = dict(policies)
        self.policy_mapping = dict(policy_mapping or {})
        return self

    def env_runners(self, *, num_env_runners: int = 2,
                    rollout_fragment_length: int = 128):
        self.num_env_runners = num_env_runners
        self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 gae_lambda: Optional[float] = None, device=None):
        if device is not None:
            self.device = device
        if lr is not None:
            self.lr = lr
        if gamma is not None:
            self.gamma = gamma
        if gae_lambda is not None:
            self.gae_lambda = gae_lambda
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """Per-policy PPO learners over multi-agent rollouts (reference:
    the MultiRLModule + per-module Learner update path)."""

    def __init__(self, config: MultiAgentPPOConfig):
        import cloudpickle

        from ray_tpu_torch.rllib.learner import PPOLearner

        if config.env_maker is None or not config.policies:
            raise ValueError("environment(env_maker) and multi_agent("
                             "policies=...) are required")
        self.config = config
        self.learners: Dict[str, PPOLearner] = {}
        for i, (pid, spec) in enumerate(sorted(config.policies.items())):
            spec = dict(spec)
            obs_dim = spec.pop("obs_dim")
            num_actions = spec.pop("num_actions")
            spec.setdefault("lr", config.lr)
            # per-policy seed offset: "independent" policies must not start
            # byte-identical (symmetry an env may never break)
            spec.setdefault("seed", config.seed + 101 * i)
            spec.setdefault("device", config.device)
            self.learners[pid] = PPOLearner(obs_dim, num_actions, **spec)
        blob = cloudpickle.dumps(config.env_maker)
        self.env_runners = [
            MultiAgentEnvRunner.remote(
                blob, seed=config.seed + 1000 * (i + 1),
                gamma=config.gamma, gae_lambda=config.gae_lambda,
                policy_mapping=config.policy_mapping,
            )
            for i in range(config.num_env_runners)
        ]
        self.iteration = 0
        self.total_steps = 0
        self._sync_weights()

    def _sync_weights(self):
        w = {pid: ln.get_weights() for pid, ln in self.learners.items()}
        ray_tpu_torch.get(
            [r.set_weights.remote(w) for r in self.env_runners], timeout=120)

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        c = self.config
        batches = ray_tpu_torch.get(
            [r.sample.remote(c.rollout_fragment_length)
             for r in self.env_runners],
            timeout=600,
        )
        merged: Dict[str, Dict[str, np.ndarray]] = {}
        for per_runner in batches:
            for pid, b in per_runner.items():
                if pid not in merged:
                    merged[pid] = {k: [v] for k, v in b.items()}
                else:
                    for k, v in b.items():
                        merged[pid][k].append(v)
        metrics: Dict[str, Any] = {}
        sampled = 0
        for pid, parts in merged.items():
            batch = {k: np.concatenate(v) for k, v in parts.items()}
            sampled += len(batch["obs"])
            for k, v in self.learners[pid].update(batch).items():
                metrics[f"{pid}/{k}"] = v
        self.total_steps += sampled
        self._sync_weights()
        returns: List[float] = []
        for r in ray_tpu_torch.get(
            [r.episode_returns.remote() for r in self.env_runners],
            timeout=120,
        ):
            returns.extend(r)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_agent_steps_sampled": sampled,
            "num_agent_steps_sampled_lifetime": self.total_steps,
            "agent_steps_per_s": sampled / max(1e-9,
                                               time.monotonic() - t0),
            "episode_return_mean": (
                float(np.mean(returns)) if returns else float("nan")),
            "num_episodes": len(returns),
            **metrics,
        }

    def get_weights(self) -> Dict[str, Any]:
        return {pid: ln.get_weights() for pid, ln in self.learners.items()}

    def set_weights(self, weights: Dict[str, Any]):
        for pid, w in weights.items():
            self.learners[pid].set_weights(w)
        self._sync_weights()

    def stop(self):
        for r in self.env_runners:
            ray_tpu_torch.kill(r)


__all__ = ["MultiAgentEnvRunner", "MultiAgentPPO", "MultiAgentPPOConfig"]
