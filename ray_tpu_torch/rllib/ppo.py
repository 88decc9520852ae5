"""PPO algorithm: config + train loop over env-runner actors and the
PyTorch learner (on CUDA unless ``training(device="cpu")``). The port's
counterpart of ``ray_tpu/rllib/ppo.py``.

Reference surface: rllib/algorithms/ppo/ppo.py:365 (PPO.training_step:
sample from EnvRunnerGroup → learner update → sync weights),
algorithm_config.py (builder-style config), algorithm.py:211 (train()
returning a result dict).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import PPOLearner


class PPOConfig:
    """Builder-style config (reference: PPOConfig.environment/env_runners/
    training chaining)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: dict = {}
        self.num_env_runners = 2
        self.rollout_fragment_length = 256
        self.lr = 3e-4
        self.gamma = 0.99
        self.gae_lambda = 0.95
        self.clip_param = 0.2
        self.num_epochs = 4
        self.minibatch_size = 128
        self.entropy_coeff = 0.0
        self.vf_loss_coeff = 0.5
        self.hidden = (64, 64)
        self.seed = 0
        self.device = None  # the learner's: None is CUDA, "cpu" the CPU

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        self.env_name = env
        self.env_config = dict(env_config or {})
        return self

    def env_runners(self, *, num_env_runners: int = 2,
                    rollout_fragment_length: int = 256):
        self.num_env_runners = num_env_runners
        self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 clip_param: Optional[float] = None,
                 num_epochs: Optional[int] = None,
                 minibatch_size: Optional[int] = None,
                 entropy_coeff: Optional[float] = None,
                 hidden: Optional[tuple] = None, device=None):
        for k, v in (("lr", lr), ("gamma", gamma), ("clip_param", clip_param),
                     ("num_epochs", num_epochs),
                     ("minibatch_size", minibatch_size),
                     ("entropy_coeff", entropy_coeff), ("hidden", hidden),
                     ("device", device)):
            if v is not None:
                setattr(self, k, v)
        return self

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    """The algorithm driver (reference: Algorithm.train() loop)."""

    def __init__(self, config: PPOConfig):
        if config.env_name is None:
            raise ValueError("config.environment(env=...) required")
        self.config = config
        import gymnasium as gym

        probe = gym.make(config.env_name, **config.env_config)
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        probe.close()
        self.learner = PPOLearner(
            obs_dim, num_actions, hidden=tuple(config.hidden), lr=config.lr,
            clip=config.clip_param, vf_coeff=config.vf_loss_coeff,
            entropy_coeff=config.entropy_coeff, num_epochs=config.num_epochs,
            minibatch_size=config.minibatch_size, seed=config.seed,
            device=config.device,
        )
        self.env_runners = [
            EnvRunner.remote(
                config.env_name, seed=config.seed + 1000 * (i + 1),
                env_config=config.env_config, gamma=config.gamma,
                gae_lambda=config.gae_lambda,
            )
            for i in range(config.num_env_runners)
        ]
        self.iteration = 0
        self._sync_weights()

    def _sync_weights(self):
        w = self.learner.get_weights()
        ray_tpu_torch.get(
            [r.set_weights.remote(w) for r in self.env_runners], timeout=120)

    def train(self) -> Dict[str, Any]:
        """One iteration: parallel sample → learner update → weight sync
        (reference: ppo.py:365 training_step)."""
        t0 = time.monotonic()
        frag = self.config.rollout_fragment_length
        batches = ray_tpu_torch.get(
            [r.sample.remote(frag) for r in self.env_runners], timeout=600)
        batch = {
            k: np.concatenate([b[k] for b in batches]) for k in batches[0]
        }
        metrics = self.learner.update(batch)
        self._sync_weights()
        returns: List[float] = []
        for r in ray_tpu_torch.get(
            [r.episode_returns.remote() for r in self.env_runners],
            timeout=120,
        ):
            returns.extend(r)
        self.iteration += 1
        sampled = len(batch["obs"])
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": sampled,
            "env_steps_per_s": sampled / max(1e-9, time.monotonic() - t0),
            "episode_return_mean": (
                float(np.mean(returns)) if returns else float("nan")),
            "num_episodes": len(returns),
            **metrics,
        }

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)
        self._sync_weights()

    def save_checkpoint(self, path: str):
        import pickle

        with open(path, "wb") as f:
            pickle.dump(self.learner.get_weights(), f)
        return path

    def restore_checkpoint(self, path: str):
        import pickle

        with open(path, "rb") as f:
            self.set_weights(pickle.load(f))

    def stop(self):
        for r in self.env_runners:
            ray_tpu_torch.kill(r)
