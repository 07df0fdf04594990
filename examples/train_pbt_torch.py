"""Population-based training on the PyTorch port: exploit/explore over the
stacked seed axis.

Usage::

    python examples/train_pbt_torch.py [--seeds 8] [--num-envs 256] \
        [--iterations 200] [--exploit-interval 20] [--device cuda]

The whole population trains as one batched program (``runners/pbt.py`` on
top of the multi-seed training of ``runners/multiseed.py``): every
``exploit_interval`` iterations the bottom quartile (by smoothed episode
reward) copies a random top-quartile member's full training state, a gather
on the device, and log-uniform-perturbs its learning rate. The per-seed
fitness, learning rates and exploit count come out with the ordinary
metrics. Runs on the CUDA device by default; ``--device cpu`` runs on the
CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rsl_rl_tpu_torch.algorithms import PPO
from rsl_rl_tpu_torch.env import Pendulum
from rsl_rl_tpu_torch.modules import ActorCritic
from rsl_rl_tpu_torch.runners.multiseed_runner import seed_sequence
from rsl_rl_tpu_torch.runners.pbt import make_pbt_train


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--iterations", type=int, default=200)
    parser.add_argument("--exploit-interval", type=int, default=20)
    parser.add_argument("--key", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    env = Pendulum(num_envs=args.num_envs, device=args.device)
    _, obs = env.reset(args.key)
    groups = {"policy": ["policy"], "critic": ["policy"]}
    policies = [ActorCritic(obs, groups, env.num_actions, actor_hidden_dims=[256, 256],
                            critic_hidden_dims=[256, 256], actor_obs_normalization=True,
                            critic_obs_normalization=True, device=args.device, seed=s)
                for s in seed_sequence(args.key, args.seeds)]
    alg = PPO(policies[0], schedule="adaptive", desired_kl=0.01, seed=args.key + 1)

    init, train_step = make_pbt_train(alg, env, num_steps_per_env=24, num_seeds=args.seeds,
                                      exploit_interval=args.exploit_interval, device=args.device)
    ts, cs, pbt = init(policies, args.key)

    t0 = time.time()
    for it in range(1, args.iterations + 1):
        ts, cs, pbt, metrics = train_step(ts, cs, pbt)
        if it % 10 == 0 or it == 1:
            fit, lr = metrics["PBT/fitness"].cpu().numpy(), metrics["PBT/lr"].cpu().numpy()
            print(f"it {it:4d} | fitness best {fit.max():8.2f} median {np.median(fit):8.2f}"
                  f" worst {fit.min():8.2f} | lr [{lr.min():.2e}, {lr.max():.2e}] | exploits"
                  f" {int(metrics['PBT/exploits'])} | {time.time() - t0:6.1f}s")

    fit = metrics["PBT/fitness"].cpu().numpy()
    print(f"best seed: {int(fit.argmax())} (fitness {fit.max():.2f})")
    return {"train_state": ts, "pbt": pbt, "metrics": metrics}


if __name__ == "__main__":
    main()
