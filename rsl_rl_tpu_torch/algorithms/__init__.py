"""On-policy algorithms; importing registers them by class name.

The JAX package's functional ``TrainState`` has no counterpart: the port's
algorithms hold their policy, optimizer moments and learning rate and update
them in place."""

from rsl_rl_tpu_torch.algorithms.distillation import Distillation
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState, EpisodeStats

__all__ = ["PPO", "Distillation", "CollectState", "EpisodeStats"]
