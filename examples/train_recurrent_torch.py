"""Train a recurrent (GRU or LSTM) PPO policy on the PyTorch port's partially
observable Pendulum.

The env hides angular velocity, so a memoryless policy plateaus while the
recurrent one can infer velocity from observation history.

Usage::

    python examples/train_recurrent_torch.py [--num-envs 1024] [--rnn gru|lstm] [--device cuda]

Runs on the CUDA device by default (the recurrent replays launch the port's
CUDA kernels there); ``--device cpu`` runs on the CPU. With ``--log-dir``
the runner writes TensorBoard scalars (``tensorboardX``) and checkpoints.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsl_rl_tpu_torch.env import PartiallyObservablePendulum
from rsl_rl_tpu_torch.runners import OnPolicyRunner


def train_cfg(rnn: str) -> dict:
    """``examples/train_recurrent.py``'s config."""
    return {
        "num_steps_per_env": 24,
        "save_interval": 100,
        "seed": 1,
        "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
        "logger": "tensorboard",
        "policy": {
            "class_name": "ActorCriticRecurrent",
            "rnn_type": rnn,
            "rnn_hidden_dim": 128,
            "rnn_num_layers": 1,
            "actor_obs_normalization": True,
            "critic_obs_normalization": True,
            "actor_hidden_dims": [128, 128],
            "critic_hidden_dims": [128, 128],
        },
        "algorithm": {
            "class_name": "PPO",
            "schedule": "adaptive",
            "desired_kl": 0.01,
            "num_mini_batches": 4,
        },
    }


def main(argv=None) -> OnPolicyRunner:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-envs", type=int, default=1024)
    parser.add_argument("--iterations", type=int, default=300)
    parser.add_argument("--rnn", type=str, default="gru", choices=["gru", "lstm"])
    parser.add_argument("--log-dir", type=str, default="logs/pendulum_po")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    env = PartiallyObservablePendulum(num_envs=args.num_envs, device=args.device)
    runner = OnPolicyRunner(env, train_cfg(args.rnn), log_dir=args.log_dir, device=args.device)
    runner.learn(args.iterations, init_at_random_ep_len=True)
    return runner


if __name__ == "__main__":
    main()
