"""Behavior cloning's learner in PyTorch — counterpart of
``ray_tpu/rllib/bc.py``'s ``BCLearner``: supervised policy updates,
cross-entropy for discrete actions and MSE for continuous ones. The config
and the algorithm, which read a Dataset, wait for the port's data plane.

Reference surface: rllib/algorithms/bc/.
"""

from __future__ import annotations

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
