"""Policy modules; importing registers them by class name."""

from rsl_rl_tpu_torch.modules.actor_critic import ActorCritic
from rsl_rl_tpu_torch.modules.actor_critic_recurrent import ActorCriticRecurrent
from rsl_rl_tpu_torch.modules.student_teacher import StudentTeacher
from rsl_rl_tpu_torch.modules.student_teacher_recurrent import StudentTeacherRecurrent

__all__ = ["ActorCritic", "ActorCriticRecurrent", "StudentTeacher", "StudentTeacherRecurrent"]
