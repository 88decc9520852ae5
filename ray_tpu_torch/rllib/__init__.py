"""Reinforcement-learning learners for the port — counterpart of the
actor-free half of ``ray_tpu/rllib``: the PPO, IMPALA (V-trace), APPO,
DQN, SAC, BC and CQL learners, the replay buffer, GAE and the connectors.
The algorithms, which drive remote env runners or read a Dataset, wait
for the port's actor runtime and data plane."""

from ray_tpu_torch.rllib import connectors
from ray_tpu_torch.rllib.bc import BCLearner
from ray_tpu_torch.rllib.cql import CQLLearner
from ray_tpu_torch.rllib.dqn import DQNLearner, ReplayBuffer
from ray_tpu_torch.rllib.learner import (APPOLearner, PPOLearner,
                                         VTraceLearner, compute_gae)
from ray_tpu_torch.rllib.sac import SACLearner

__all__ = ["APPOLearner", "BCLearner", "CQLLearner", "DQNLearner",
           "PPOLearner", "ReplayBuffer", "SACLearner", "VTraceLearner",
           "compute_gae", "connectors"]
