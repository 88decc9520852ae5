"""Behavior cloning's learner in PyTorch — counterpart of
``ray_tpu/rllib/bc.py``'s ``BCLearner``: supervised policy updates,
cross-entropy for discrete actions and MSE for continuous ones, on CUDA
unless ``training(device="cpu")``; then the config and the algorithm,
which read a ``ray_tpu_torch.data`` Dataset.

Reference surface: rllib/algorithms/bc/.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.learner import (_adam, _take, _trainable,
                                         copy_weights, init_mlp, mlp_apply,
                                         to_numpy)


class BCLearner:
    """Supervised policy updates."""

    def __init__(self, obs_dim: int, act_out: int, *, discrete: bool,
                 hidden=(128, 128), lr: float = 1e-3, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.discrete = discrete
        self.lr = lr
        self.params = _trainable({"policy": init_mlp(
            torch.Generator().manual_seed(seed),
            [obs_dim, *hidden, act_out], self.device)})
        self.opt = _adam(self.params, lr)

    def _loss(self, obs, actions):
        out = mlp_apply(self.params["policy"], obs)
        if self.discrete:
            return -_take(torch.log_softmax(out, -1), actions).mean()
        return ((out - actions) ** 2).mean()

    def update(self, obs: np.ndarray, actions: np.ndarray) -> float:
        loss = self._loss(
            torch.as_tensor(np.asarray(obs), dtype=torch.float32,
                            device=self.device),
            torch.as_tensor(np.asarray(actions), device=self.device,
                            dtype=torch.int64 if self.discrete
                            else torch.float32))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    def act(self, obs: np.ndarray):
        with torch.no_grad():
            out = mlp_apply(self.params["policy"], torch.as_tensor(
                np.asarray(obs, np.float32)[None], device=self.device))[0]
        if self.discrete:
            return int(torch.argmax(out))
        return out.cpu().numpy()

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights):
        """Copy in ``weights`` and reset the optimizer's state."""
        copy_weights(self.params, weights)
        self.opt = _adam(self.params, self.lr)


class BCConfig:
    """Builder-style config (reference: BCConfig in
    rllib/algorithms/bc/bc.py)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: dict = {}
        self.dataset = None
        self.obs_column = "obs"
        self.action_column = "action"
        self.hidden = [128, 128]
        self.lr = 1e-3
        self.train_batch_size = 256
        self.seed = 0
        # continuous datasets logged in tanh-space (the SAC runner's
        # convention) need squash+rescale to env bounds at evaluation
        self.action_squash = False
        self.device = None  # the learner's: None is CUDA, "cpu" the CPU

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        """Optional: used only by evaluate()."""
        self.env_name = env
        self.env_config = dict(env_config or {})
        return self

    def offline_data(self, dataset, *, obs_column: str = "obs",
                     action_column: str = "action"):
        """`dataset` is a ray_tpu_torch.data Dataset of rows holding an
        observation vector and an action (reference: AlgorithmConfig
        .offline_data(input_=...) reading through Ray Data)."""
        self.dataset = dataset
        self.obs_column = obs_column
        self.action_column = action_column
        return self

    def training(self, *, lr: Optional[float] = None,
                 train_batch_size: Optional[int] = None,
                 hidden: Optional[List[int]] = None,
                 action_squash: Optional[bool] = None, device=None):
        for name, value in (("lr", lr),
                            ("train_batch_size", train_batch_size),
                            ("hidden", hidden),
                            ("action_squash", action_squash),
                            ("device", device)):
            if value is not None:
                setattr(self, name, value)
        return self

    def build(self) -> "BC":
        return BC(self)


class BC:
    """Offline behavior cloning driver (reference: bc.py)."""

    def __init__(self, config: BCConfig):
        if config.dataset is None:
            raise ValueError("config.offline_data(dataset) required")
        self.config = config
        # materialize once: every epoch re-streams the same block refs
        self._ds = config.dataset.materialize()
        sample = self._ds.take(1)[0]
        obs = np.asarray(sample[config.obs_column], np.float32)
        action = sample[config.action_column]
        self.discrete = np.issubdtype(np.asarray(action).dtype, np.integer)
        if self.discrete:
            # scan the dataset for the true action-space size
            act_out = int(self._ds.max(config.action_column)) + 1
        else:
            act_out = int(np.prod(np.shape(action)) or 1)
        self.learner = BCLearner(
            obs_dim=int(np.prod(obs.shape)), act_out=act_out,
            discrete=self.discrete, hidden=tuple(config.hidden),
            lr=config.lr, seed=config.seed, device=config.device)
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        """One shuffled pass over the offline dataset."""
        t0 = time.monotonic()
        c = self.config
        losses = []
        n = 0
        for batch in self._ds.random_shuffle().iter_batches(
                batch_size=c.train_batch_size):
            obs = np.asarray(batch[c.obs_column], np.float32)
            acts = np.asarray(batch[c.action_column])
            if len(obs) < 2:
                continue
            losses.append(self.learner.update(obs, acts))
            n += len(obs)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "num_samples_trained": n,
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "samples_per_s": n / max(1e-9, time.monotonic() - t0),
        }

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        """Greedy rollouts of the cloned policy in the configured env."""
        if self.config.env_name is None:
            raise ValueError("config.environment(env=...) needed to evaluate")
        import gymnasium as gym

        env = gym.make(self.config.env_name, **self.config.env_config)

        def to_env_action(a):
            if self.discrete:
                return a
            space = env.action_space
            low = np.asarray(space.low, np.float32)
            high = np.asarray(space.high, np.float32)
            if self.config.action_squash:
                # tanh-space dataset actions: squash + rescale to bounds
                # (mirrors EnvRunner._env_action)
                a = np.tanh(np.asarray(a, np.float32))
                return (low + (a + 1.0) * 0.5 * (high - low)).astype(
                    np.float32)
            return np.clip(np.asarray(a, np.float32), low, high)

        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=self.config.seed + ep)
            total, done = 0.0, False
            while not done:
                a = self.learner.act(np.asarray(obs, np.float32).ravel())
                obs, r, term, trunc, _ = env.step(to_env_action(a))
                total += float(r)
                done = term or trunc
            returns.append(total)
        env.close()
        return {"episode_return_mean": float(np.mean(returns)),
                "num_episodes": num_episodes}

    def get_weights(self):
        return to_numpy(self.learner.params)
