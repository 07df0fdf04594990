"""Train N independent PPO seeds at once on the PyTorch port
(``MultiSeedRunner``: the seeds' states stacked and the policy run through
``torch.func.vmap``).

Usage::

    python examples/train_multiseed_torch.py [--seeds 8] [--num-envs 512] \
        [--iterations 100] [--log-dir logs/multiseed] [--device cuda]

Every iteration runs collect + update for all seeds; the console and
TensorBoard carry the cross-seed mean +/- std curves. With a log dir the
study checkpoints every ``save_interval`` iterations (stacked;
``MultiSeedRunner.load`` resumes it), and the best seed is saved as a
single-seed checkpoint that ``OnPolicyRunner.load`` takes. Runs on the CUDA
device by default; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsl_rl_tpu_torch.env import Pendulum
from rsl_rl_tpu_torch.runners import MultiSeedRunner


def train_cfg(seed: int) -> dict:
    """``examples/train_multiseed.py``'s config."""
    return {
        "num_steps_per_env": 24,
        "save_interval": 50,
        "seed": seed,
        "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
        "logger": "tensorboard",
        "policy": {
            "class_name": "ActorCritic",
            "actor_hidden_dims": [256, 256, 256],
            "critic_hidden_dims": [256, 256, 256],
            "actor_obs_normalization": True,
            "critic_obs_normalization": True,
        },
        "algorithm": {"class_name": "PPO", "schedule": "adaptive", "desired_kl": 0.01},
    }


def main(argv=None) -> MultiSeedRunner:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--num-envs", type=int, default=512)
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument("--key", type=int, default=0)
    parser.add_argument("--log-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    env = Pendulum(num_envs=args.num_envs, device=args.device)
    runner = MultiSeedRunner(env, train_cfg(args.key), num_seeds=args.seeds, log_dir=args.log_dir,
                             device=args.device)
    runner.learn(args.iterations)

    if args.log_dir:
        # the best seed, for deployment through OnPolicyRunner.load
        rew, ep_count = runner.seed_rewards()
        if ep_count == 0:
            print("no completed episodes in the trailing window — cannot rank seeds; train longer before"
                  " exporting a best seed.")
            return runner
        best = int(np.argmax(rew))
        path = os.path.join(args.log_dir, f"best_seed_{best}.pt")
        runner.save_seed(path, best)
        print(f"best seed {best} (reward {rew[best]:.2f}) exported to {path}")
    return runner


if __name__ == "__main__":
    main()
