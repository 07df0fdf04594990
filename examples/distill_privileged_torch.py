"""Privileged-teacher distillation on the PyTorch port's domain-randomized
physics env.

The sim-to-real recipe: train an RL teacher that sees the per-episode
randomized link masses (``DomainRandomizedNLink``'s ``"privileged"`` obs
group), save its checkpoint, load it into a ``DistillationRunner`` (the
checkpoint's actor becomes the frozen teacher) and distill a student that
only sees the base proprioceptive observation. The teacher goes through the
file on disk, as a user's would.

Usage::

    python examples/distill_privileged_torch.py [--num-envs 1024] [--device cuda]

Runs on the CUDA device by default; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsl_rl_tpu_torch.env import DomainRandomizedNLink
from rsl_rl_tpu_torch.runners import DistillationRunner, OnPolicyRunner

#: ``examples/distill_privileged.py``'s teacher, on the privileged obs
TEACHER_CFG = {
    "num_steps_per_env": 24,
    "save_interval": 100,
    "seed": 1,
    "obs_groups": {"policy": ["privileged"], "critic": ["privileged"]},
    "logger": "tensorboard",
    "policy": {
        "class_name": "ActorCritic",
        "actor_obs_normalization": True,
        "critic_obs_normalization": True,
        "actor_hidden_dims": [256, 256, 256],
        "critic_hidden_dims": [256, 256, 256],
        "noise_std_floor": 0.01,
        "dtype": torch.bfloat16,
    },
    "algorithm": {"class_name": "PPO", "schedule": "adaptive", "desired_kl": 0.01},
}
#: its student sees the base observation; the frozen teacher evaluates on the
#: privileged group it was trained on
STUDENT_CFG = {
    "num_steps_per_env": 24,
    "save_interval": 100,
    "seed": 2,
    "obs_groups": {"policy": ["policy"], "teacher": ["privileged"]},
    "logger": "tensorboard",
    "policy": {
        "class_name": "StudentTeacher",
        "student_obs_normalization": True,
        "teacher_obs_normalization": True,
        "student_hidden_dims": [256, 256, 256],
        "teacher_hidden_dims": [256, 256, 256],
        "dtype": torch.bfloat16,
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
    parser.add_argument("--teacher-iterations", type=int, default=300)
    parser.add_argument("--distill-iterations", type=int, default=150)
    parser.add_argument("--log-dir", type=str, default="logs/distill_privileged")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    # ---- phase 1: RL teacher on the privileged observation (masses visible)
    teacher_dir = os.path.join(args.log_dir, "teacher")
    env = DomainRandomizedNLink(num_envs=args.num_envs, num_links=5, device=args.device)
    teacher_runner = OnPolicyRunner(env, TEACHER_CFG, log_dir=teacher_dir, device=args.device)
    teacher_runner.learn(args.teacher_iterations)
    teacher_ckpt = os.path.join(teacher_dir, f"model_{teacher_runner.current_learning_iteration}.pt")

    # ---- phase 2: distill into a student that sees only the base obs
    student_runner = DistillationRunner(DomainRandomizedNLink(num_envs=args.num_envs, num_links=5, device=args.device),
                                        STUDENT_CFG, log_dir=os.path.join(args.log_dir, "student"),
                                        device=args.device)
    student_runner.load(teacher_ckpt)  # remaps actor -> teacher, not a resume
    student_runner.learn(args.distill_iterations)
    return student_runner


if __name__ == "__main__":
    main()
