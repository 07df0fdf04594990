"""On-policy algorithms; importing registers them by class name."""

from rsl_rl_tpu_torch.algorithms.distillation import Distillation
from rsl_rl_tpu_torch.algorithms.ppo import PPO

__all__ = ["Distillation", "PPO"]
