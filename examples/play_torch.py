"""Evaluate a checkpoint of the PyTorch port: a deterministic rollout and its
episode statistics, beside a random-action baseline (the counterpart of
``examples/play.py``)::

    python examples/play_torch.py --ckpt logs/pendulum/model_199.pt [--env Pendulum] [--num-envs 64]
        [--steps 400] [--config cfg.yaml] [--export policy.pt2] [--device cuda]

The rollout runs a fresh copy of the env with the policy's mean action
(``utils/evaluation.py::evaluate_policy``) and prints the mean, min and max
of the completed episodes' returns. ``--export PATH`` also writes the
deterministic policy as a ``torch.export`` program (``utils/export.py``),
which ``load_policy(PATH)`` runs without the port's classes. Runs on the
CUDA device by default; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

# allow running from a repo checkout without installing the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import rsl_rl_tpu_torch.env  # noqa: F401  (registers the envs)
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from rsl_rl_tpu_torch.utils.config import load_train_cfg
from rsl_rl_tpu_torch.utils.evaluation import evaluate_policy
from rsl_rl_tpu_torch.utils.export import export_policy
from rsl_rl_tpu_torch.utils.registry import resolve

# examples/train_pendulum_torch.py's policy: the config when --config is not given
DEFAULT_CFG = {
    "num_steps_per_env": 24,
    "save_interval": 50,
    "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
    "policy": {
        "class_name": "ActorCritic",
        "activation": "elu",
        "actor_obs_normalization": True,
        "critic_obs_normalization": True,
        "actor_hidden_dims": [256, 256, 256],
        "critic_hidden_dims": [256, 256, 256],
        "init_noise_std": 1.0,
    },
    "algorithm": {"class_name": "PPO"},
}


def _line(name: str, m: dict) -> str:
    return (f"{name} : {int(m['Eval/episode_count'])} episodes | mean return {m['Eval/mean_reward']:10.2f}"
            f" | min {m['Eval/min_return']:10.2f} | max {m['Eval/max_return']:10.2f}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--env", type=str, default="Pendulum", help="a registered functional env")
    parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--config", type=str, default=None,
                        help="training config YAML (its policy block must match the checkpoint);"
                             " defaults to examples/train_pendulum_torch.py's")
    parser.add_argument("--no-baseline", action="store_true", help="skip the random-action baseline")
    parser.add_argument("--export", type=str, default=None, metavar="PATH",
                        help="also write the deterministic policy as a torch.export program")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    cfg = load_train_cfg(args.config) if args.config else dict(DEFAULT_CFG)
    env = resolve("env", args.env)(num_envs=args.num_envs, device=args.device)
    runner = OnPolicyRunner(env, cfg, device=args.device)
    runner.load(args.ckpt)
    policy = runner.alg.policy
    out = {"policy": evaluate_policy(env, policy, None, args.steps, args.seed)}
    if out["policy"]["Eval/episode_count"] == 0:
        print(f"no episode completed within {args.steps} steps — increase --steps")
    else:
        print(_line("policy", out["policy"]))
    if not args.no_baseline:
        out["random"] = evaluate_policy(env, policy, None, args.steps, args.seed, random_actions=True)
        if out["random"]["Eval/episode_count"] > 0:
            print(_line("random", out["random"]))
    if args.export:
        export_policy(policy, runner.collect_state.obs, args.export)
        print(f"exported the deterministic policy to {args.export}")
    return out


if __name__ == "__main__":
    main()
