"""APPO: asynchronous PPO — IMPALA's pipeline with a clipped surrogate.

Reference surface: rllib/algorithms/appo/appo.py (APPO "shares IMPALA's
machinery": continuous async sampling, per-fragment updates) +
appo_torch_learner.py (PPO clip on V-trace advantages, target value
network). The driver IS the IMPALA driver — only the learner differs. The
port's counterpart of ``ray_tpu/rllib/appo.py``.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.learner import APPOLearner


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.target_update_freq = 8

    def training(self, *, clip_param: Optional[float] = None,
                 target_update_freq: Optional[int] = None, **kwargs):
        super().training(**kwargs)
        if clip_param is not None:
            self.clip_param = clip_param
        if target_update_freq is not None:
            self.target_update_freq = target_update_freq
        return self

    def build(self) -> "APPO":
        return APPO(self)


class APPO(IMPALA):
    def _make_learner(self, config, obs_dim: int, num_actions: int):
        return APPOLearner(
            obs_dim, num_actions, hidden=tuple(config.hidden), lr=config.lr,
            gamma=config.gamma,
            rho_bar=config.vtrace_clip_rho_threshold,
            c_bar=config.vtrace_clip_c_threshold,
            clip_param=config.clip_param,
            vf_coeff=config.vf_loss_coeff,
            entropy_coeff=config.entropy_coeff,
            target_update_freq=config.target_update_freq,
            seed=config.seed, device=config.device,
        )


__all__ = ["APPO", "APPOConfig"]
