"""DQN's replay buffer and learner in PyTorch — counterpart of the
actor-free half of ``ray_tpu/rllib/dqn.py`` (``ReplayBuffer``,
``DQNLearner``). The config and the algorithm, which sample
through remote env runners, wait for the port's actor runtime.

Reference surface: rllib/algorithms/dqn/ and dqn_rainbow_torch_learner.py's
double-Q loss.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
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
