"""Data-parallel PPO on the PyTorch port's Pendulum env over ``torch.distributed``
(the counterpart of ``examples/train_multihost.py``).

Launch the same script once a rank with ``torchrun``; each rank takes the
card of its ``LOCAL_RANK`` (NCCL), or the CPU with ``--device cpu`` (Gloo)::

    torchrun --standalone --nproc-per-node 4 examples/train_multihost_torch.py --num-envs 32768 --iterations 1000
    torchrun --standalone --nproc-per-node 2 examples/train_multihost_torch.py --device cpu --num-envs 64 --iterations 2

``--num-envs`` is the global env count: each data rank steps its
contiguous shard, and the losses and parameters are those of one process
over all of them (``rsl_rl_tpu_torch/parallel``). Each rank replays its
iteration as one CUDA graph (``fuse_iteration``), which needs NCCL: one
rank a card. Rank 0 alone prints,
writes the scalars and the git state and saves the checkpoints in
``--log-dir``. Without ``torchrun`` it trains in one process.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from rsl_rl_tpu_torch.env import Pendulum  # noqa: E402
from rsl_rl_tpu_torch.parallel import distributed_init  # noqa: E402
from rsl_rl_tpu_torch.runners import OnPolicyRunner  # noqa: E402


def train_cfg(seed: int) -> dict:
    """``examples/train_multihost.py``'s config: each iteration one CUDA
    graph a rank, its NCCL collectives inside (on the CPU it runs eagerly)."""
    return {
        "num_steps_per_env": 24,
        "save_interval": 100,
        "seed": seed,
        "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
        "logger": "tensorboard",
        "fuse_iteration": True,
        "policy": {
            "class_name": "ActorCritic",
            "actor_obs_normalization": True,
            "critic_obs_normalization": True,
            "actor_hidden_dims": [256, 256, 256],
            "critic_hidden_dims": [256, 256, 256],
        },
        "algorithm": {"class_name": "PPO", "schedule": "adaptive", "desired_kl": 0.01},
    }


def main(argv=None) -> OnPolicyRunner:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-envs", type=int, default=32768, help="the global env count")
    parser.add_argument("--iterations", type=int, default=1000)
    parser.add_argument("--log-dir", type=str, default=None)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cuda", local_rank) if args.device == "cuda" else torch.device("cpu")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        distributed_init(backend="nccl" if device.type == "cuda" else "gloo", init_method="env://",
                         rank=int(os.environ["RANK"]), world_size=world,
                         device_id=device if device.type == "cuda" else None)
    rank = torch.distributed.get_rank() if world > 1 else 0
    if rank == 0:
        print(f"ranks={world} device={device} global envs={args.num_envs}")

    env = Pendulum(num_envs=args.num_envs, device=device)
    runner = OnPolicyRunner(env, train_cfg(args.seed), log_dir=args.log_dir, device=device)
    runner.learn(args.iterations)
    if world > 1:
        torch.distributed.destroy_process_group()
    return runner


if __name__ == "__main__":
    main()
