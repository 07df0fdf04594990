"""Train PPO on the PyTorch port's Pendulum env.

Usage::

    python examples/train_pendulum_torch.py [--num-envs 4096] [--iterations 200] [--device cuda]

Runs on the CUDA device by default; ``--device cpu`` runs on the CPU. With
``--log-dir`` the runner writes TensorBoard scalars (``tensorboardX``) and
checkpoints there; ``--resume`` continues from the newest checkpoint in it.
"""

from __future__ import annotations

import argparse
import os
import sys

# allow running from a repo checkout without installing the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsl_rl_tpu_torch.env import Pendulum
from rsl_rl_tpu_torch.runners import OnPolicyRunner


def train_cfg(seed: int) -> dict:
    """``examples/train_pendulum.py``'s config."""
    return {
        "num_steps_per_env": 24,
        "save_interval": 50,
        "seed": seed,
        "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
        "logger": "tensorboard",
        "policy": {
            "class_name": "ActorCritic",
            "activation": "elu",
            "actor_obs_normalization": True,
            "critic_obs_normalization": True,
            "actor_hidden_dims": [256, 256, 256],
            "critic_hidden_dims": [256, 256, 256],
            "init_noise_std": 1.0,
        },
        "algorithm": {
            "class_name": "PPO",
            "learning_rate": 1e-3,
            "num_learning_epochs": 5,
            "num_mini_batches": 4,
            "schedule": "adaptive",
            "desired_kl": 0.01,
            "entropy_coef": 0.01,
            "gamma": 0.99,
            "lam": 0.95,
            "max_grad_norm": 1.0,
        },
    }


def main(argv=None) -> OnPolicyRunner:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-envs", type=int, default=4096)
    parser.add_argument("--iterations", type=int, default=200)
    parser.add_argument("--log-dir", type=str, default=None)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest checkpoint in --log-dir, if any")
    args = parser.parse_args(argv)

    env = Pendulum(num_envs=args.num_envs, device=args.device)
    runner = OnPolicyRunner(env, train_cfg(args.seed), log_dir=args.log_dir, device=args.device)
    if args.resume and runner.load_latest():
        print(f"resumed from iteration {runner.current_learning_iteration}")
    runner.learn(args.iterations)
    return runner


if __name__ == "__main__":
    main()
