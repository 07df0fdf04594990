"""The teacher-student pipeline on the PyTorch port: train an RL teacher,
then distill it into a student.

Train with ``OnPolicyRunner``, load the RL checkpoint into a
``DistillationRunner`` (the checkpoint's actor becomes the frozen teacher),
distill.

Usage::

    python examples/distill_student_torch.py [--num-envs 1024] [--device cuda]

Runs on the CUDA device by default; ``--device cpu`` runs on the CPU. Both
runners write TensorBoard scalars (``tensorboardX``) and checkpoints under
``--log-dir``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsl_rl_tpu_torch.env import Pendulum
from rsl_rl_tpu_torch.runners import DistillationRunner, OnPolicyRunner

#: ``examples/distill_student.py``'s teacher
TEACHER_CFG = {
    "num_steps_per_env": 24,
    "save_interval": 100,
    "seed": 1,
    "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
    "logger": "tensorboard",
    "policy": {
        "class_name": "ActorCritic",
        "actor_obs_normalization": True,
        "critic_obs_normalization": True,
        "actor_hidden_dims": [256, 256, 256],
        "critic_hidden_dims": [256, 256, 256],
    },
    "algorithm": {"class_name": "PPO", "schedule": "adaptive", "desired_kl": 0.01},
}
#: and its student (the student's and the teacher's obs sets can differ;
#: here both see "policy")
STUDENT_CFG = {
    "num_steps_per_env": 24,
    "save_interval": 100,
    "seed": 2,
    "obs_groups": {"policy": ["policy"], "teacher": ["policy"]},
    "logger": "tensorboard",
    "policy": {
        "class_name": "StudentTeacher",
        "student_obs_normalization": True,
        "teacher_obs_normalization": True,
        "student_hidden_dims": [256, 256, 256],
        "teacher_hidden_dims": [256, 256, 256],
    },
    "algorithm": {
        "class_name": "Distillation",
        "learning_rate": 1e-3,
        "gradient_length": 15,
        "num_learning_epochs": 1,
    },
}


def main(argv=None) -> DistillationRunner:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-envs", type=int, default=1024)
    parser.add_argument("--teacher-iterations", type=int, default=200)
    parser.add_argument("--distill-iterations", type=int, default=100)
    parser.add_argument("--log-dir", type=str, default="logs/distill")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    # ---- phase 1: RL teacher on the full observation
    teacher_dir = os.path.join(args.log_dir, "teacher")
    teacher_runner = OnPolicyRunner(Pendulum(num_envs=args.num_envs, device=args.device), TEACHER_CFG,
                                    log_dir=teacher_dir, device=args.device)
    teacher_runner.learn(args.teacher_iterations)
    teacher_ckpt = os.path.join(teacher_dir, f"model_{teacher_runner.current_learning_iteration}.pt")

    # ---- phase 2: distill into a student
    student_runner = DistillationRunner(Pendulum(num_envs=args.num_envs, device=args.device), STUDENT_CFG,
                                        log_dir=os.path.join(args.log_dir, "student"), device=args.device)
    student_runner.load(teacher_ckpt)  # remaps actor -> teacher, not a resume
    student_runner.learn(args.distill_iterations)
    return student_runner


if __name__ == "__main__":
    main()
