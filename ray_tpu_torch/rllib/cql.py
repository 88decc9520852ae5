"""CQL's learner in PyTorch — counterpart of ``ray_tpu/rllib/cql.py``'s
``CQLLearner``: conservative Q-learning (double Q, target networks and
the discrete penalty logsumexp(Q(s, .)) - Q(s, a_data) of Kumar et al.
2020, Eq. 4). The config and the algorithm, which read a Dataset, wait for
the port's data plane.

Reference surface: rllib/algorithms/cql/.
"""

from __future__ import annotations

from typing import Dict

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
