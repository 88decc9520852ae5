"""DQN in PyTorch — counterpart of ``ray_tpu/rllib/dqn.py``: the replay
buffer, the learner (on CUDA unless ``training(device="cpu")``), the config
and the algorithm, which samples through remote env runners.

Reference surface: rllib/algorithms/dqn/ and dqn_rainbow_torch_learner.py's
double-Q loss.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import (_adam, _frozen_copy, _trainable,
                                         batch_tensors, copy_weights,
                                         init_mlp, mlp_apply, to_numpy)


class ReplayBuffer:
    """Uniform ring-buffer replay (reference:
    rllib/utils/replay_buffers/replay_buffer.py); numpy, the JAX
    package's, copied: the same seed gives the same draws."""

    FIELDS = ("obs", "next_obs", "actions", "rewards", "terminated")

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(batch["obs"])
        if self._store is None:
            self._store = {
                k: np.zeros((self.capacity, *np.shape(batch[k])[1:]),
                            dtype=np.asarray(batch[k]).dtype)
                for k in self.FIELDS
            }
        # vectorized ring insert: at most two slice assignments per field
        # (split at the wrap point) — this runs on the training loop's hot
        # path
        start = 0
        while start < n:
            take = min(n - start, self.capacity - self._next)
            for k in self.FIELDS:
                self._store[k][self._next:self._next + take] = (
                    batch[k][start:start + take])
            self._next = (self._next + take) % self.capacity
            self._size = min(self._size + take, self.capacity)
            start += take

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, self._size, size=batch_size)
        return {k: self._store[k][idx] for k in self.FIELDS}


DQN_COLUMNS = {"obs": torch.float32, "next_obs": torch.float32,
               "actions": torch.int64, "rewards": torch.float32,
               "terminated": torch.float32}


class DQNLearner:
    """Double-DQN updates with a periodically-synced target net."""

    def __init__(self, obs_dim: int, num_actions: int, *,
                 hidden=(128, 128), lr: float = 5e-4, gamma: float = 0.99,
                 target_update_freq: int = 200, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        sizes = [obs_dim, *hidden, num_actions]
        self.params = _trainable({"q": init_mlp(
            torch.Generator().manual_seed(seed), sizes, self.device)})
        self.target_params = _frozen_copy(self.params)
        self.lr = lr
        self.opt = _adam(self.params, lr)
        self.gamma = gamma
        self.target_update_freq = target_update_freq
        self.updates = 0

    def _loss(self, batch):
        q_all = mlp_apply(self.params["q"], batch["obs"])
        q_sa = q_all.gather(1, batch["actions"][:, None])[:, 0]
        # double DQN: online net picks, target net evaluates
        with torch.no_grad():
            next_online = mlp_apply(self.params["q"], batch["next_obs"])
            next_target = mlp_apply(self.target_params["q"],
                                    batch["next_obs"])
            best = torch.argmax(next_online, dim=1)
            next_q = next_target.gather(1, best[:, None])[:, 0]
            target = batch["rewards"] + self.gamma * (
                1.0 - batch["terminated"]) * next_q
        td = q_sa - target
        # optax.huber_loss at delta 1
        loss = F.huber_loss(q_sa, target, reduction="mean", delta=1.0)
        return loss, td.detach().abs().mean()

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        loss, td_abs = self._loss(batch_tensors(batch, DQN_COLUMNS,
                                                self.device))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.updates += 1
        if self.updates % self.target_update_freq == 0:
            self.target_params = _frozen_copy(self.params)
        loss, td_abs = torch.stack([loss.detach(), td_abs]).tolist()
        return {"qf_loss": loss, "td_error_abs": td_abs}

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights):
        """Copy in ``weights``, sync the target and reset the optimizer's
        state, as JAX's ``set_weights`` re-inits optax's."""
        copy_weights(self.params, weights)
        self.target_params = _frozen_copy(self.params)
        self.opt = _adam(self.params, self.lr)


class DQNConfig:
    """Builder-style config (reference: DQNConfig in
    rllib/algorithms/dqn/dqn.py)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: dict = {}
        self.num_env_runners = 2
        self.rollout_fragment_length = 128
        self.hidden = [128, 128]
        self.lr = 5e-4
        self.gamma = 0.99
        self.buffer_size = 50_000
        self.train_batch_size = 64
        self.num_updates_per_iter = 64
        self.learning_starts = 500
        self.target_update_freq = 200
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 5_000
        self.seed = 0
        self.env_to_module = None
        self.module_to_env = None
        self.device = None  # the learner's: None is CUDA, "cpu" the CPU

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        self.env_name = env
        self.env_config = dict(env_config or {})
        return self

    def env_runners(self, *, num_env_runners: int = 2,
                    rollout_fragment_length: int = 128,
                    env_to_module=None, module_to_env=None):
        self.num_env_runners = num_env_runners
        self.rollout_fragment_length = rollout_fragment_length
        self.env_to_module = env_to_module
        self.module_to_env = module_to_env
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 buffer_size: Optional[int] = None,
                 train_batch_size: Optional[int] = None,
                 num_updates_per_iter: Optional[int] = None,
                 learning_starts: Optional[int] = None,
                 target_update_freq: Optional[int] = None,
                 epsilon_timesteps: Optional[int] = None,
                 hidden: Optional[List[int]] = None, device=None):
        for name, value in (
            ("lr", lr), ("gamma", gamma), ("buffer_size", buffer_size),
            ("train_batch_size", train_batch_size),
            ("num_updates_per_iter", num_updates_per_iter),
            ("learning_starts", learning_starts),
            ("target_update_freq", target_update_freq),
            ("epsilon_timesteps", epsilon_timesteps), ("hidden", hidden),
            ("device", device),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    """The algorithm driver (reference: dqn.py training_step)."""

    def __init__(self, config: DQNConfig):
        if config.env_name is None:
            raise ValueError("config.environment(env=...) required")
        self.config = config
        import gymnasium as gym

        probe = gym.make(config.env_name, **config.env_config)
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        probe.close()
        self.learner = DQNLearner(
            obs_dim, num_actions, hidden=tuple(config.hidden), lr=config.lr,
            gamma=config.gamma, target_update_freq=config.target_update_freq,
            seed=config.seed, device=config.device,
        )
        self.buffer = ReplayBuffer(config.buffer_size, seed=config.seed)
        self.env_runners = [
            EnvRunner.remote(
                config.env_name, seed=config.seed + 1000 * (i + 1),
                env_config=config.env_config, policy_kind="epsilon_greedy",
                env_to_module=config.env_to_module,
                module_to_env=config.module_to_env,
            )
            for i in range(config.num_env_runners)
        ]
        self.iteration = 0
        self.total_steps = 0
        self._sync_weights()

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self.total_steps / max(1, c.epsilon_timesteps))
        return c.epsilon_initial + frac * (c.epsilon_final - c.epsilon_initial)

    def _sync_weights(self):
        w = self.learner.get_weights()
        eps = self._epsilon()
        ray_tpu_torch.get(
            [ref for r in self.env_runners
             for ref in (r.set_weights.remote(w),
                         r.set_exploration.remote(eps))],
            timeout=120)

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        c = self.config
        batches = ray_tpu_torch.get(
            [r.sample_raw.remote(c.rollout_fragment_length)
             for r in self.env_runners],
            timeout=600,
        )
        for b in batches:
            self.buffer.add_batch(b)
            self.total_steps += len(b["obs"])
        metrics: Dict[str, float] = {}
        if len(self.buffer) >= c.learning_starts:
            for _ in range(c.num_updates_per_iter):
                metrics = self.learner.update(
                    self.buffer.sample(c.train_batch_size))
        self._sync_weights()
        returns: List[float] = []
        for r in ray_tpu_torch.get(
            [r.episode_returns.remote() for r in self.env_runners],
            timeout=120,
        ):
            returns.extend(r)
        self.iteration += 1
        sampled = sum(len(b["obs"]) for b in batches)
        return {
            "training_iteration": self.iteration,
            "num_env_steps_sampled": sampled,
            "num_env_steps_sampled_lifetime": self.total_steps,
            "env_steps_per_s": sampled / max(1e-9, time.monotonic() - t0),
            "epsilon": self._epsilon(),
            "replay_buffer_size": len(self.buffer),
            "num_target_syncs": self.learner.updates
            // max(1, c.target_update_freq),
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
