"""ray_tpu_torch.rllib — reinforcement learning on the port's actor plane
with PyTorch learners; the counterpart of ``ray_tpu/rllib`` with the same
exports (reference surface: rllib/algorithms/*, core/learner/*,
env/env_runner_group.py).

The algorithms (PPO, IMPALA, APPO, DQN, SAC, BC, CQL, MultiAgentPPO) drive
``EnvRunner`` actors, which infer on their CPU and never touch CUDA, or
read a ``ray_tpu_torch.data`` Dataset (BC, CQL). Their learners run on
CUDA unless the config's ``training(device="cpu")`` says otherwise; weights
cross to the runners as numpy, as in the JAX package."""

from ray_tpu_torch.rllib import connectors
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNLearner, ReplayBuffer
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import PPOLearner, compute_gae
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.cql import CQL, CQLConfig, CQLLearner
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.learner import APPOLearner, VTraceLearner
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACLearner
from ray_tpu_torch.rllib.bc import BC, BCConfig, BCLearner
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)

__all__ = ["BC", "BCConfig", "BCLearner", "DQN", "DQNConfig", "DQNLearner",
           "EnvRunner", "IMPALA", "IMPALAConfig", "MultiAgentEnvRunner",
           "MultiAgentPPO", "MultiAgentPPOConfig", "PPO", "PPOConfig",
           "PPOLearner", "ReplayBuffer", "SAC", "SACConfig", "SACLearner",
           "VTraceLearner", "compute_gae", "connectors"]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("rllib")
del _rlu
