"""Train the PyTorch port's PPO on real MuJoCo (the CPU simulator) through the
host-env path.

The 5-link swing-up of ``NLinkPendulum`` on the actual simulator
(``rsl_rl_tpu_torch/env/mujoco_host.py``), trained by ``OnPolicyRunner``'s
host collection loop: the policy acts and learns on ``--device``, ``mj_step``
runs on the host, one ``MjData`` an env. Any simulator that keeps its own
state trains the same way: subclass ``HostVecEnv`` (``is_jax = False``).

Usage::

    python examples/train_mujoco_host_torch.py [--num-envs 64] [--iterations 150] [--num-links 5]
                                               [--log-dir DIR] [--device cuda]

Needs the ``mujoco`` package. Runs the policy on the CUDA device by default;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

# allow running from a repo checkout without installing the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsl_rl_tpu_torch.env import MuJoCoNLinkEnv
from rsl_rl_tpu_torch.runners import OnPolicyRunner


def train_cfg(seed: int) -> dict:
    """``examples/train_mujoco_host.py``'s config."""
    return {
        "num_steps_per_env": 24,
        "save_interval": 100,
        "seed": seed,
        "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
        "logger": "tensorboard",
        "policy": {
            "class_name": "ActorCritic",
            "activation": "elu",
            "actor_hidden_dims": [128, 128],
            "critic_hidden_dims": [128, 128],
            "actor_obs_normalization": True,
            "critic_obs_normalization": True,
        },
        "algorithm": {
            "class_name": "PPO",
            "learning_rate": 1.0e-3,
            "schedule": "adaptive",
            "desired_kl": 0.01,
            "num_learning_epochs": 5,
            "num_mini_batches": 4,
        },
    }


def main(argv=None) -> OnPolicyRunner:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--iterations", type=int, default=150)
    p.add_argument("--num-links", type=int, default=5)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    env = MuJoCoNLinkEnv(num_envs=args.num_envs, num_links=args.num_links, seed=args.seed)
    cfg = train_cfg(args.seed)
    runner = OnPolicyRunner(env, cfg, log_dir=args.log_dir, device=args.device)
    runner.learn(args.iterations, init_at_random_ep_len=True)
    print(f"Trained on real MuJoCo: {args.iterations} iterations x {args.num_envs} envs x"
          f" {cfg['num_steps_per_env']} steps through the host-env loop.")
    return runner


if __name__ == "__main__":
    main()
