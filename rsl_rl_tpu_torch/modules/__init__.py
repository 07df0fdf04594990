"""Policy modules (actor-critics, student-teachers), RND and symmetry;
importing registers the policies by class name.

The JAX package's functional states ``PolicyState`` and ``RNDState`` have
no counterpart: the port's policies and RND are ``nn.Module``s that hold
their parameters and normalizers."""

from rsl_rl_tpu_torch.modules.actor_critic import ActorCritic
from rsl_rl_tpu_torch.modules.actor_critic_recurrent import ActorCriticRecurrent
from rsl_rl_tpu_torch.modules.policy import concat_obs, obs_set_dim
from rsl_rl_tpu_torch.modules.rnd import RandomNetworkDistillation, resolve_rnd_config
from rsl_rl_tpu_torch.modules.student_teacher import StudentTeacher
from rsl_rl_tpu_torch.modules.student_teacher_recurrent import StudentTeacherRecurrent
from rsl_rl_tpu_torch.modules.symmetry import resolve_symmetry_config

__all__ = ["ActorCritic", "ActorCriticRecurrent", "StudentTeacher", "StudentTeacherRecurrent", "concat_obs",
           "obs_set_dim", "RandomNetworkDistillation", "resolve_rnd_config", "resolve_symmetry_config"]
