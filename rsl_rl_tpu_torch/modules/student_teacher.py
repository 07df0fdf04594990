"""Student-teacher distillation policy, feedforward (counterpart of
``rsl_rl_tpu/modules/student_teacher.py``): a trainable student MLP and a
frozen teacher MLP.

The JAX package keeps the teacher in ``PolicyState.aux`` so the optimizer
never sees it; here the teacher's parameters (and a recurrent teacher's
memory) have ``requires_grad=False``, and the distillation algorithm trains
the parameters that require gradients: ``student``, ``std`` and a
recurrent student's ``memory_s``. Parameters are fp32; ``dtype`` runs the
MLP trunks (and memories) in that compute dtype with fp32 heads, as
:class:`~rsl_rl_tpu_torch.modules.actor_critic.ActorCritic` does.

Checkpoints (:meth:`StudentTeacher.load_policy_state`): an ``ActorCritic``
model state maps ``actor`` -> ``teacher`` and ``norm_actor`` ->
``norm_teacher`` and is not a resume; a ``StudentTeacher`` state restores in
full and is one.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from rsl_rl_tpu_torch.modules.policy import check_state_compatible, concat_obs, obs_set_dim
from rsl_rl_tpu_torch.networks.mlp import MLP
from rsl_rl_tpu_torch.ops.running_norm import RunningNormState, normalize, update_running_norm
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import register


def _sub_state(state: dict, prefix: str) -> dict | None:
    """The entries of ``state`` under ``prefix.``, prefix stripped (None if none)."""
    sub = {k[len(prefix) + 1:]: v for k, v in state.items() if k.startswith(prefix + ".")}
    return sub or None


@register("policy")
class StudentTeacher(nn.Module):
    """Student MLP (trained, Gaussian with a learned std) and teacher MLP
    (frozen, loaded from an RL checkpoint).

    Parameters are drawn on the CPU from a generator seeded with ``seed``
    and then moved to ``device``.
    """

    is_recurrent = False

    def __init__(
        self,
        obs: dict[str, torch.Tensor],
        obs_groups: dict[str, list[str]],
        num_actions: int,
        student_obs_normalization: bool = False,
        teacher_obs_normalization: bool = False,
        student_hidden_dims: list[int] = (256, 256, 256),
        teacher_hidden_dims: list[int] = (256, 256, 256),
        activation: str = "elu",
        init_noise_std: float = 0.1,
        noise_std_type: str = "scalar",
        dtype: Any = None,
        device: str | torch.device = "cuda",
        seed: int = 0,
        trunk_inputs: tuple[int | None, int | None] = (None, None),
        **kwargs,
    ):
        super().__init__()
        if kwargs:
            print(
                "StudentTeacher.__init__ got unexpected arguments, which will be ignored: "
                + str(list(kwargs.keys()))
            )
        if noise_std_type not in ("scalar", "log"):
            raise ValueError(
                f"Unknown standard deviation type: {noise_std_type}. Should be 'scalar' or 'log'"
            )
        self.device = resolve_device(device)
        self.obs_groups = obs_groups
        self.num_actions = num_actions
        self.num_student_obs = obs_set_dim(obs, obs_groups["policy"])
        self.num_teacher_obs = obs_set_dim(obs, obs_groups["teacher"])
        self.noise_std_type = noise_std_type
        self.dtype = dtype
        self.loaded_teacher = False
        # the recurrent subclass feeds memory outputs to the MLPs
        student_in = trunk_inputs[0] or self.num_student_obs
        teacher_in = trunk_inputs[1] or self.num_teacher_obs
        head = torch.float32 if dtype is not None else None
        gen = torch.Generator().manual_seed(int(seed))
        self.student = MLP(student_in, num_actions, list(student_hidden_dims), activation, gen,
                           dtype=dtype, head_dtype=head)
        self.teacher = MLP(teacher_in, num_actions, list(teacher_hidden_dims), activation, gen,
                           dtype=dtype, head_dtype=head)
        self.teacher.requires_grad_(False)
        std0 = init_noise_std * torch.ones(num_actions)
        self.std = nn.Parameter(std0 if noise_std_type == "scalar" else torch.log(std0))
        self.norm_student = RunningNormState(self.num_student_obs) if student_obs_normalization else None
        self.norm_teacher = RunningNormState(self.num_teacher_obs) if teacher_obs_normalization else None
        self.to(self.device)

    # ------------------------------------------------------------- carries

    def forward(self, method: str, *args):
        """``self.<method>(*args)``: lets ``torch.func.functional_call`` run any
        policy method with a substituted state (a study's seeds)."""
        return getattr(self, method)(*args)

    def initial_carry(self, num_envs: int) -> Any:
        return ()

    def reset_carry(self, carry: Any, dones: torch.Tensor) -> Any:
        return carry

    # ------------------------------------------------------------- forward

    def _student_in(self, obs: dict[str, torch.Tensor]) -> torch.Tensor:
        x = concat_obs(obs, self.obs_groups["policy"])
        return normalize(self.norm_student, x) if self.norm_student is not None else x

    def _teacher_in(self, obs: dict[str, torch.Tensor]) -> torch.Tensor:
        x = concat_obs(obs, self.obs_groups["teacher"])
        return normalize(self.norm_teacher, x) if self.norm_teacher is not None else x

    def _std(self, mean: torch.Tensor) -> torch.Tensor:
        std = self.std if self.noise_std_type == "scalar" else torch.exp(self.std)
        return std.expand_as(mean)

    def act(self, obs, carry):
        """The student's action distribution: ``(mean, std, carry)``."""
        mean = self.student(self._student_in(obs))
        return mean, self._std(mean), carry

    @torch.no_grad()
    def evaluate(self, obs, carry):
        """The teacher's mean action, without gradients: ``(action, carry)``."""
        return self.teacher(self._teacher_in(obs)), carry

    def act_inference(self, obs, carry=()):
        """The student's deterministic action (the mean) and the carry."""
        return self.student(self._student_in(obs)), carry

    def student_seq(self, obs, carry0, resets):
        """The student's actions over a time-major ``[T, N, ...]`` window,
        the distillation update's replay: ``(actions [T, N, A], carry)``;
        feedforward, time folds into the batch and the carry passes through."""
        return self.student(self._student_in(obs)), carry0

    # -------------------------------------------------------- normalization

    @torch.no_grad()
    def update_normalization(self, obs: dict[str, torch.Tensor]) -> None:
        """Only the student's normalizer moves during distillation."""
        if self.norm_student is not None:
            update_running_norm(self.norm_student, concat_obs(obs, self.obs_groups["policy"]))

    # ----------------------------------------------------------- checkpoint

    def _teacher_parts(self, state: dict) -> list[tuple[nn.Module, dict, str]]:
        """What an RL checkpoint's model state gives the teacher: ``(module,
        its state, name)`` for the teacher MLP (the actor's) and its
        normalizer (the actor's), which must agree in whether they normalize."""
        loaded_norm = _sub_state(state, "norm_actor")
        if (loaded_norm is None) != (self.norm_teacher is None):
            raise ValueError(
                "Teacher obs-normalization mismatch: the RL checkpoint's actor "
                f"{'has' if loaded_norm is not None else 'has no'} normalizer stats but the "
                "distillation policy was configured with teacher_obs_normalization="
                f"{self.norm_teacher is not None}. Set teacher_obs_normalization to "
                "match how the teacher was trained."
            )
        parts = [(self.teacher, _sub_state(state, "actor"), "teacher network")]
        if loaded_norm is not None:
            parts.append((self.norm_teacher, loaded_norm, "teacher normalizer"))
        return parts

    def load_policy_state(self, state: dict) -> bool:
        """Restore from an RL checkpoint's model state (teacher bootstrap,
        returns ``False``: not a resume) or a distillation checkpoint's (a
        full restore, returns ``True``). Every part is checked before any is
        copied; a mismatch raises ``ValueError``."""
        if any(k.startswith("actor.") for k in state):
            parts = self._teacher_parts(state)
            for module, sub, what in parts:
                check_state_compatible(module.state_dict(), sub, what)
            for module, sub, _ in parts:
                module.load_state_dict(sub)
            self.loaded_teacher = True
            return False
        if any(k.startswith("student.") for k in state):
            check_state_compatible(self.state_dict(), state)
            self.load_state_dict(state)
            self.loaded_teacher = True
            return True
        raise ValueError("state does not contain student or teacher parameters")
