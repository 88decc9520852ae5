"""IMPALA: asynchronous sample + learn with V-trace correction.

Reference surface: rllib/algorithms/impala/impala.py:526 — env runners
sample continuously and the learner consumes fragments as they arrive (no
synchronous barrier per iteration); stale behavior policies are corrected
by V-trace (learner.py VTraceLearner). Weight updates flow back to each
runner right after its fragment is consumed, fire-and-forget. The port's
counterpart of ``ray_tpu/rllib/impala.py``; the learner runs on CUDA
unless ``training(device="cpu")``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import VTraceLearner


class IMPALAConfig:
    """Builder-style config (reference: IMPALAConfig chaining)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: dict = {}
        self.num_env_runners = 2
        self.rollout_fragment_length = 128
        self.lr = 5e-4
        self.gamma = 0.99
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.hidden = (64, 64)
        self.train_batches_per_iteration = 8
        self.seed = 0
        self.device = None  # the learner's: None is CUDA, "cpu" the CPU

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        self.env_name = env
        self.env_config = dict(env_config or {})
        return self

    def env_runners(self, *, num_env_runners: int = 2,
                    rollout_fragment_length: int = 128):
        self.num_env_runners = num_env_runners
        self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 vf_loss_coeff: Optional[float] = None,
                 hidden: Optional[tuple] = None,
                 train_batches_per_iteration: Optional[int] = None,
                 device=None):
        for k, v in (("lr", lr), ("gamma", gamma),
                     ("entropy_coeff", entropy_coeff),
                     ("vf_loss_coeff", vf_loss_coeff), ("hidden", hidden),
                     ("train_batches_per_iteration",
                      train_batches_per_iteration), ("device", device)):
            if v is not None:
                setattr(self, k, v)
        return self

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA:
    """Async driver: a pool of in-flight sample futures; each arrival is one
    SGD step, then that runner (alone) gets fresh weights and resamples —
    the other runners keep generating with their (slightly stale) policies,
    which V-trace corrects (reference: impala.py training_step)."""

    def __init__(self, config: IMPALAConfig):
        if config.env_name is None:
            raise ValueError("config.environment(env=...) required")
        self.config = config
        import gymnasium as gym

        probe = gym.make(config.env_name, **config.env_config)
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        probe.close()
        self.learner = self._make_learner(config, obs_dim, num_actions)
        self.env_runners = [
            EnvRunner.remote(
                config.env_name, seed=config.seed + 1000 * (i + 1),
                env_config=config.env_config,
            )
            for i in range(config.num_env_runners)
        ]
        w = self.learner.get_weights()
        ray_tpu_torch.get(
            [r.set_weights.remote(w) for r in self.env_runners], timeout=120)
        frag = config.rollout_fragment_length
        # prime the async pipeline: every runner has a fragment in flight
        self._inflight: Dict[Any, Any] = {
            r.sample_raw.remote(frag): r for r in self.env_runners
        }
        self.iteration = 0
        self._steps_total = 0

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        frag = cfg.rollout_fragment_length
        t0 = time.monotonic()
        metrics: Dict[str, float] = {}
        steps = 0
        for _ in range(cfg.train_batches_per_iteration):
            ready, _ = ray_tpu_torch.wait(
                [getattr(ref, "_ref", ref) for ref in self._inflight],
                num_returns=1, timeout=300,
            )
            # map back: _inflight keys are the original (maybe wrapped) refs
            ready_key = None
            for ref in self._inflight:
                if getattr(ref, "_ref", ref) in ready or ref in ready:
                    ready_key = ref
                    break
            if ready_key is None:
                continue
            runner = self._inflight.pop(ready_key)
            batch = ray_tpu_torch.get(ready_key, timeout=120)
            metrics = self.learner.update(batch)
            steps += len(batch["obs"])
            # async weight push + immediate resample: no barrier with the
            # other runners (fire-and-forget — V-trace absorbs the lag)
            runner.set_weights.remote(self.learner.get_weights())
            self._inflight[runner.sample_raw.remote(frag)] = runner
        returns: List[float] = []
        for r in ray_tpu_torch.get(
            [r.episode_returns.remote() for r in self.env_runners],
            timeout=120,
        ):
            returns.extend(r)
        self.iteration += 1
        self._steps_total += steps
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": steps,
            "num_env_steps_total": self._steps_total,
            "env_steps_per_s": steps / max(1e-9, time.monotonic() - t0),
            "episode_return_mean": (
                float(np.mean(returns)) if returns else float("nan")),
            "num_episodes": len(returns),
            **metrics,
        }

    def _make_learner(self, config, obs_dim: int, num_actions: int):
        return VTraceLearner(
            obs_dim, num_actions, hidden=tuple(config.hidden), lr=config.lr,
            gamma=config.gamma,
            rho_bar=config.vtrace_clip_rho_threshold,
            c_bar=config.vtrace_clip_c_threshold,
            vf_coeff=config.vf_loss_coeff,
            entropy_coeff=config.entropy_coeff, seed=config.seed,
            device=config.device,
        )

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self):
        for r in self.env_runners:
            ray_tpu_torch.kill(r)


__all__ = ["IMPALA", "IMPALAConfig"]
