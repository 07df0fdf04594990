"""Recurrent student-teacher distillation policy (counterpart of
``rsl_rl_tpu/modules/student_teacher_recurrent.py``): a GRU or LSTM
``Memory`` in front of the student MLP (``memory_s``) and, with
``teacher_recurrent``, a frozen one in front of the teacher (``memory_t``).
The carry is ``{"student": ..., "teacher": ... or ()}``.

The distillation update replays the student over a window with
:meth:`StudentTeacherRecurrent.student_seq`, through
``Memory.sequence_with_carry``: the x-streaming GRU or LSTM kernels at one
stream on the card. An RL checkpoint of a recurrent policy gives
``memory_t`` its ``memory_a``.
"""

from __future__ import annotations

import warnings

import torch

from rsl_rl_tpu_torch.modules.student_teacher import StudentTeacher, _sub_state
from rsl_rl_tpu_torch.networks.memory import Memory, mask_carry
from rsl_rl_tpu_torch.utils.registry import register


@register("policy")
class StudentTeacherRecurrent(StudentTeacher):
    is_recurrent = True

    def __init__(
        self,
        obs,
        obs_groups,
        num_actions,
        rnn_type: str = "lstm",
        rnn_hidden_dim: int = 256,
        rnn_num_layers: int = 1,
        teacher_recurrent: bool = False,
        **kwargs,
    ):
        if "rnn_hidden_size" in kwargs:
            warnings.warn(
                "The argument `rnn_hidden_size` is deprecated and will be removed in a future"
                " version. Please use `rnn_hidden_dim` instead.",
                DeprecationWarning,
            )
            if rnn_hidden_dim == 256:
                rnn_hidden_dim = kwargs.pop("rnn_hidden_size")
        # a recurrent teacher's MLP sees its memory's output
        trunk_inputs = (rnn_hidden_dim, rnn_hidden_dim if teacher_recurrent else None)
        super().__init__(obs, obs_groups, num_actions, trunk_inputs=trunk_inputs, **kwargs)
        self.rnn_type = rnn_type
        self.rnn_hidden_dim = rnn_hidden_dim
        self.rnn_num_layers = rnn_num_layers
        self.teacher_recurrent = teacher_recurrent
        gen = torch.Generator().manual_seed(int(kwargs.get("seed", 0)) + 1)
        self.memory_s = Memory(self.num_student_obs, rnn_hidden_dim, rnn_type, rnn_num_layers,
                               compute_dtype=self.dtype, generator=gen)
        self.memory_t = None
        if teacher_recurrent:
            self.memory_t = Memory(self.num_teacher_obs, rnn_hidden_dim, rnn_type, rnn_num_layers,
                                   compute_dtype=self.dtype, generator=gen).requires_grad_(False)
        self.to(self.device)

    # ------------------------------------------------------------- carries

    def initial_carry(self, num_envs: int):
        teacher = self.memory_t.initialize_carry(num_envs, self.device) if self.teacher_recurrent else ()
        return {"student": self.memory_s.initialize_carry(num_envs, self.device), "teacher": teacher}

    def reset_carry(self, carry, dones: torch.Tensor):
        """Zero the hidden states of done envs."""
        teacher = mask_carry(carry["teacher"], dones) if self.teacher_recurrent else ()
        return {"student": mask_carry(carry["student"], dones), "teacher": teacher}

    # ------------------------------------------------------------- forward

    def act(self, obs, carry):
        new_s, features = self.memory_s.step(carry["student"], self._student_in(obs))
        mean = self.student(features)
        return mean, self._std(mean), {**carry, "student": new_s}

    @torch.no_grad()
    def evaluate(self, obs, carry):
        x = self._teacher_in(obs)
        new_t = carry["teacher"]
        if self.teacher_recurrent:
            new_t, x = self.memory_t.step(carry["teacher"], x)
        return self.teacher(x), {**carry, "teacher": new_t}

    def act_inference(self, obs, carry):
        new_s, features = self.memory_s.step(carry["student"], self._student_in(obs))
        return self.student(features), {**carry, "student": new_s}

    def student_seq(self, obs, carry0, resets):
        """The student's replay of a ``[T, N]`` window from ``carry0`` with
        ``resets[t] = done[t-1]``: ``(actions [T, N, A], carry)``, the
        student's carry after the last step value-only, the teacher's
        passed through."""
        features, final_s = self.memory_s.sequence_with_carry(carry0["student"], self._student_in(obs), resets)
        return self.student(features), {**carry0, "student": final_s}

    # ----------------------------------------------------------- checkpoint

    def _teacher_parts(self, state: dict):
        parts = super()._teacher_parts(state)
        if self.teacher_recurrent:
            memory_a = _sub_state(state, "memory_a")
            if memory_a is None:
                raise ValueError(
                    "teacher_recurrent=True requires an RL checkpoint from a recurrent policy"
                    " (missing 'memory_a' parameters)"
                )
            parts.append((self.memory_t, memory_a, "teacher memory"))
        return parts
