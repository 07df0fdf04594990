"""Distillation runner (counterpart of
``rsl_rl_tpu/runners/distillation_runner.py``): the on-policy loop with a
student-teacher policy and the distillation algorithm. It differs in the
default obs set (``teacher``) and in refusing to learn before a teacher is
loaded (``load`` of an RL checkpoint), so a fused run captures its iteration
with the teacher in place.
"""

from __future__ import annotations

from rsl_rl_tpu_torch.runners.on_policy_runner import OnPolicyRunner
from rsl_rl_tpu_torch.utils.registry import resolve


class DistillationRunner(OnPolicyRunner):
    """On-policy runner for teacher-student training."""

    training_type = "distillation"

    def _construct_algorithm(self, obs, seed: int):
        """The student-teacher policy and the distillation algorithm (no
        ``empirical_normalization`` shim, as in the JAX package)."""
        policy_class = resolve("policy", self.policy_cfg.pop("class_name"))
        policy = policy_class(obs, self.cfg["obs_groups"], self.env.num_actions,
                              device=self.device, seed=seed, **self.policy_cfg)
        alg_class = resolve("algorithm", self.alg_cfg.pop("class_name"))
        return alg_class(policy, seed=seed + 1, **self.alg_cfg)

    def learn(self, num_learning_iterations: int, init_at_random_ep_len: bool = False) -> None:
        if not self.alg.policy.loaded_teacher:
            raise ValueError("Teacher model parameters not loaded. Please load a teacher model to distill.")
        super().learn(num_learning_iterations, init_at_random_ep_len)
