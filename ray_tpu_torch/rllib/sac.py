"""SAC's learner in PyTorch — counterpart of ``ray_tpu/rllib/sac.py``'s
``SACLearner``: a squashed-Gaussian actor, twin critics, an automatic
temperature and polyak-averaged targets. The config and the algorithm
wait for the port's actor runtime.

Reference surface: rllib/algorithms/sac/ and sac_torch_learner.py's
losses. The stop-gradients are JAX's: the actor's loss takes the critics
with their parameters detached but keeps the action's graph (so the
actor's gradient flows through the critics' inputs); alpha is detached in
the critic and actor losses and not in its own.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.convert import nest_map
from ray_tpu_torch.rllib.learner import (ADAM_BETAS, ADAM_EPS, LOG_STD_MAX,
                                         LOG_STD_MIN, _frozen_copy,
                                         _trainable, batch_tensors,
                                         copy_weights, init_mlp, leaves,
                                         mlp_apply, to_numpy)

SAC_COLUMNS = {"obs": torch.float32, "next_obs": torch.float32,
               "actions": torch.float32, "rewards": torch.float32,
               "terminated": torch.float32}


def _actor_dist(params, obs):
    mu, log_std = mlp_apply(params["actor"], obs).chunk(2, dim=-1)
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def _sample_action(params, obs, noise):
    """A reparameterised tanh-squashed Gaussian action from the standard
    normal draws ``noise``, and its log-prob."""
    mu, log_std = _actor_dist(params, obs)
    std = torch.exp(log_std)
    u = mu + std * noise
    a = torch.tanh(u)
    logp = (-0.5 * (((u - mu) / std) ** 2 + 2 * log_std
                    + math.log(2 * math.pi))).sum(-1)
    logp = logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)
    return a, logp


def _q_apply(qp, obs, act):
    return mlp_apply(qp, torch.cat([obs, act], -1))[:, 0]


class SACLearner:
    """SAC updates: actor, twin critics, temperature, targets."""

    def __init__(self, obs_dim: int, act_dim: int, *, hidden=(256, 256),
                 actor_lr: float = 3e-4, critic_lr: float = 3e-4,
                 alpha_lr: float = 3e-4, gamma: float = 0.99,
                 tau: float = 0.005, target_entropy: Optional[float] = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.params = _trainable({
            "actor": init_mlp(gen, [obs_dim, *hidden, 2 * act_dim],
                              self.device),
            "q1": init_mlp(gen, [obs_dim + act_dim, *hidden, 1], self.device),
            "q2": init_mlp(gen, [obs_dim + act_dim, *hidden, 1], self.device),
            "log_alpha": torch.zeros((), device=self.device),
        })
        self.target = {"q1": _frozen_copy(self.params["q1"]),
                       "q2": _frozen_copy(self.params["q2"])}
        self._lrs = (actor_lr, critic_lr, alpha_lr)
        self.opt = self._optimizer()
        self.gamma = gamma
        self.tau = tau
        self.updates = 0
        self.act_dim = act_dim
        self.tgt_ent = (-float(act_dim) if target_entropy is None
                        else float(target_entropy))
        # the action noise, when update() is not handed JAX's draws
        self._noise = torch.Generator().manual_seed(seed + 1)

    def _optimizer(self) -> torch.optim.Adam:
        """optax.multi_transform of three adams: one parameter group each
        for the actor, the critics and the temperature."""
        actor_lr, critic_lr, alpha_lr = self._lrs
        p = self.params
        return torch.optim.Adam([
            {"params": leaves(p["actor"]), "lr": actor_lr},
            {"params": leaves([p["q1"], p["q2"]]), "lr": critic_lr},
            {"params": [p["log_alpha"]], "lr": alpha_lr},
        ], betas=ADAM_BETAS, eps=ADAM_EPS)

    def _losses(self, batch, noise):
        params, target = self.params, self.target
        alpha = torch.exp(params["log_alpha"])
        alpha_sg = alpha.detach()
        # critic target: entropy-regularized twin-min bootstrap
        with torch.no_grad():
            next_a, next_logp = _sample_action(params, batch["next_obs"],
                                               noise[0])
            tq = torch.minimum(
                _q_apply(target["q1"], batch["next_obs"], next_a),
                _q_apply(target["q2"], batch["next_obs"], next_a),
            ) - alpha_sg * next_logp
            y = batch["rewards"] + self.gamma * (
                1.0 - batch["terminated"]) * tq
        q1 = _q_apply(params["q1"], batch["obs"], batch["actions"])
        q2 = _q_apply(params["q2"], batch["obs"], batch["actions"])
        critic_loss = ((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean()
        # actor: reparameterized, against the CURRENT critics, whose
        # parameters are detached and whose input (the action) is not
        a, logp = _sample_action(params, batch["obs"], noise[1])
        q1_sg, q2_sg = (nest_map(torch.Tensor.detach, params[k])
                        for k in ("q1", "q2"))
        q_pi = torch.minimum(_q_apply(q1_sg, batch["obs"], a),
                             _q_apply(q2_sg, batch["obs"], a))
        actor_loss = (alpha_sg * logp - q_pi).mean()
        # temperature: drive entropy toward the target
        alpha_loss = (-alpha * (logp + self.tgt_ent).detach()).mean()
        total = critic_loss + actor_loss + alpha_loss
        return total, (critic_loss, actor_loss, alpha, -logp.mean())

    def update(self, batch: Dict[str, np.ndarray],
               noise: Optional[Sequence[np.ndarray]] = None
               ) -> Dict[str, float]:
        """One update. ``noise``: the two standard-normal draws (B,
        act_dim) for the next-state and the current-state actions (JAX's
        ``normal(k1)``, ``normal(k2)``); drawn from the learner's
        generator when None."""
        tb = batch_tensors(batch, SAC_COLUMNS, self.device)
        shape = (2, len(batch["obs"]), self.act_dim)
        noise = (torch.randn(shape, generator=self._noise) if noise is None
                 else torch.as_tensor(np.asarray(noise), dtype=torch.float32)
                 ).to(self.device)
        total, aux = self._losses(tb, noise)
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        self.opt.step()
        with torch.no_grad():
            for t, p in zip(leaves(self.target),
                            leaves({"q1": self.params["q1"],
                                    "q2": self.params["q2"]})):
                t.copy_((1 - self.tau) * t + self.tau * p)
        self.updates += 1
        values = torch.stack([a.detach() for a in aux]).tolist()
        return dict(zip(("critic_loss", "actor_loss", "alpha", "entropy"),
                        values))

    def get_weights(self):
        return to_numpy(self.params)

    def set_weights(self, weights):
        """Copy in ``weights``, sync the targets and reset the optimizer's
        state, as JAX's ``set_weights`` re-inits optax's."""
        copy_weights(self.params, weights)
        self.target = {"q1": _frozen_copy(self.params["q1"]),
                       "q2": _frozen_copy(self.params["q2"])}
        self.opt = self._optimizer()
