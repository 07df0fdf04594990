"""Policy modules; importing registers them by class name."""

from rsl_rl_tpu_torch.modules.actor_critic import ActorCritic
from rsl_rl_tpu_torch.modules.actor_critic_recurrent import ActorCriticRecurrent

__all__ = ["ActorCritic", "ActorCriticRecurrent"]
