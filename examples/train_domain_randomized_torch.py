"""Domain-randomized training with an asymmetric (privileged) critic on the
PyTorch port.

PPO on ``DomainRandomizedNLink``: every episode each env draws fresh
log-uniform link-mass scales. The actor sees only the proprioceptive
observation (it must be robust to the unobserved plant variation); the
critic sees the ``"privileged"`` group, which appends ``log(mass_scale)``
(the critic is discarded at deployment). The same privileged group feeds the
teacher of ``examples/distill_privileged_torch.py``.

Usage::

    python examples/train_domain_randomized_torch.py [--num-envs 4096]
        [--iterations 500] [--mass-range 0.5 2.0] [--log-dir DIR] [--device cuda]

Runs on the CUDA device by default; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsl_rl_tpu_torch.env import DomainRandomizedNLink
from rsl_rl_tpu_torch.runners import OnPolicyRunner


def train_cfg(seed: int) -> dict:
    """``examples/train_domain_randomized.py``'s config (bf16 MLP trunks)."""
    return {
        "num_steps_per_env": 24,
        "save_interval": 100,
        "seed": seed,
        # asymmetric actor-critic: actor blind to the scales, critic not
        "obs_groups": {"policy": ["policy"], "critic": ["privileged"]},
        "logger": "tensorboard",
        "policy": {
            "class_name": "ActorCritic",
            "activation": "elu",
            "actor_hidden_dims": [256, 256, 256],
            "critic_hidden_dims": [256, 256, 256],
            "actor_obs_normalization": True,
            "critic_obs_normalization": True,
            "dtype": torch.bfloat16,
        },
        "algorithm": {
            "class_name": "PPO",
            "learning_rate": 1.0e-3,
            "schedule": "adaptive",
            "desired_kl": 0.01,
            "num_learning_epochs": 5,
            "num_mini_batches": "auto",
        },
    }


def main(argv=None) -> OnPolicyRunner:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--num-links", type=int, default=5)
    p.add_argument("--mass-range", type=float, nargs=2, default=[0.5, 2.0])
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    env = DomainRandomizedNLink(num_envs=args.num_envs, num_links=args.num_links,
                                mass_scale_range=tuple(args.mass_range), device=args.device)
    runner = OnPolicyRunner(env, train_cfg(args.seed), log_dir=args.log_dir, device=args.device)
    runner.learn(args.iterations, init_at_random_ep_len=True)
    return runner


if __name__ == "__main__":
    main()
