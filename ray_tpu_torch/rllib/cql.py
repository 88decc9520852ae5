"""CQL's learner in PyTorch — counterpart of ``ray_tpu/rllib/cql.py``'s
``CQLLearner``: conservative Q-learning (double Q, target networks and
the discrete penalty logsumexp(Q(s, .)) - Q(s, a_data) of Kumar et al.
2020, Eq. 4), on CUDA unless ``training(device="cpu")``; then the config
and the algorithm, which read a ``ray_tpu_torch.data`` Dataset.

Reference surface: rllib/algorithms/cql/.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.learner import (_adam, _frozen_copy, _take,
                                         _trainable, batch_tensors,
                                         copy_weights, init_mlp, mlp_apply,
                                         to_numpy)

CQL_COLUMNS = {"obs": torch.float32, "action": torch.int64,
               "reward": torch.float32, "next_obs": torch.float32,
               "terminated": torch.float32}


class CQLLearner:
    """Conservative Q updates (double Q + target networks)."""

    def __init__(self, obs_dim: int, num_actions: int, *,
                 hidden=(128, 128), lr: float = 3e-4, gamma: float = 0.99,
                 cql_alpha: float = 1.0, target_update_freq: int = 200,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        sizes = [obs_dim, *hidden, num_actions]
        self.params = _trainable({"q1": init_mlp(gen, sizes, self.device),
                                  "q2": init_mlp(gen, sizes, self.device)})
        self.target_params = _frozen_copy(self.params)
        self.lr = lr
        self.opt = _adam(self.params, lr)
        self.gamma = gamma
        self.cql_alpha = cql_alpha
        self.target_update_freq = target_update_freq
        self._updates = 0

    def _loss(self, b):
        q1 = mlp_apply(self.params["q1"], b["obs"])
        q2 = mlp_apply(self.params["q2"], b["obs"])
        q1_a, q2_a = _take(q1, b["action"]), _take(q2, b["action"])
        # double-Q target from the lagging networks: the minimum of the
        # two, then the best action
        with torch.no_grad():
            tq1 = mlp_apply(self.target_params["q1"], b["next_obs"])
            tq2 = mlp_apply(self.target_params["q2"], b["next_obs"])
            next_q = torch.minimum(tq1, tq2).max(dim=1).values
            target = b["reward"] + self.gamma * (
                1.0 - b["terminated"]) * next_q
        td = 0.5 * (((q1_a - target) ** 2) + ((q2_a - target) ** 2))
        # conservative penalty: push down Q on actions outside the data
        cql = (torch.logsumexp(q1, dim=1) - q1_a
               + torch.logsumexp(q2, dim=1) - q2_a)
        return (td + self.cql_alpha * cql).mean(), td.mean(), cql.mean()

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        loss, td, cql = self._loss(batch_tensors(batch, CQL_COLUMNS,
                                                 self.device))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self._updates += 1
        if self._updates % self.target_update_freq == 0:
            self.target_params = _frozen_copy(self.params)
        loss, td, cql = torch.stack(
            [loss.detach(), td.detach(), cql.detach()]).tolist()
        return {"loss": loss, "td_loss": td, "cql_penalty": cql}

    def act(self, obs: np.ndarray) -> int:
        with torch.no_grad():
            q = mlp_apply(self.params["q1"], torch.as_tensor(
                np.asarray(obs, np.float32)[None], device=self.device))[0]
        return int(torch.argmax(q))

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights):
        """Copy in ``weights``, sync the targets and reset the optimizer's
        state."""
        copy_weights(self.params, weights)
        self.target_params = _frozen_copy(self.params)
        self.opt = _adam(self.params, self.lr)


class CQLConfig:
    """Builder-style config (reference: CQLConfig)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.env_config: dict = {}
        self.dataset = None
        self.hidden = [128, 128]
        self.lr = 3e-4
        self.gamma = 0.99
        self.cql_alpha = 1.0
        self.target_update_freq = 200
        self.train_batch_size = 256
        self.seed = 0
        self.device = None  # the learner's: None is CUDA, "cpu" the CPU

    def environment(self, env: str, *, env_config: Optional[dict] = None):
        self.env_name = env
        self.env_config = dict(env_config or {})
        return self

    def offline_data(self, dataset):
        """Dataset of {obs, action, reward, next_obs, terminated} rows."""
        self.dataset = dataset
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 cql_alpha: Optional[float] = None,
                 target_update_freq: Optional[int] = None,
                 train_batch_size: Optional[int] = None,
                 hidden: Optional[List[int]] = None, device=None):
        for name, value in (("lr", lr), ("gamma", gamma),
                            ("cql_alpha", cql_alpha),
                            ("target_update_freq", target_update_freq),
                            ("train_batch_size", train_batch_size),
                            ("hidden", hidden), ("device", device)):
            if value is not None:
                setattr(self, name, value)
        return self

    def build(self) -> "CQL":
        return CQL(self)


class CQL:
    """Offline conservative Q-learning driver."""

    def __init__(self, config: CQLConfig):
        if config.dataset is None:
            raise ValueError("config.offline_data(dataset) required")
        self.config = config
        self._ds = config.dataset.materialize()
        sample = self._ds.take(1)[0]
        obs = np.asarray(sample["obs"], np.float32)
        num_actions = int(self._ds.max("action")) + 1
        self.learner = CQLLearner(
            obs_dim=int(np.prod(obs.shape)), num_actions=num_actions,
            hidden=tuple(config.hidden), lr=config.lr, gamma=config.gamma,
            cql_alpha=config.cql_alpha,
            target_update_freq=config.target_update_freq, seed=config.seed,
            device=config.device)
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        """One shuffled pass of conservative Q updates."""
        t0 = time.monotonic()
        c = self.config
        metrics_acc: List[Dict[str, float]] = []
        n = 0
        for batch in self._ds.random_shuffle().iter_batches(
                batch_size=c.train_batch_size):
            if len(batch["obs"]) < 2:
                continue
            metrics_acc.append(self.learner.update(batch))
            n += len(batch["obs"])
        self.iteration += 1
        agg = {k: float(np.mean([m[k] for m in metrics_acc]))
               for k in metrics_acc[0]} if metrics_acc else {}
        return {
            "training_iteration": self.iteration,
            "num_samples_trained": n,
            "samples_per_s": n / max(1e-9, time.monotonic() - t0),
            **agg,
        }

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        if self.config.env_name is None:
            raise ValueError("config.environment(env=...) needed to evaluate")
        import gymnasium as gym

        env = gym.make(self.config.env_name, **self.config.env_config)
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=self.config.seed + ep)
            total, done = 0.0, False
            while not done:
                a = self.learner.act(np.asarray(obs, np.float32).ravel())
                obs, r, term, trunc, _ = env.step(a)
                total += float(r)
                done = term or trunc
            returns.append(total)
        env.close()
        return {"episode_return_mean": float(np.mean(returns)),
                "num_episodes": num_episodes}

    def get_weights(self):
        return to_numpy(self.learner.params)


__all__ = ["CQL", "CQLConfig", "CQLLearner"]
