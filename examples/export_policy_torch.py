"""Export a checkpoint of the PyTorch port through every deployment path.

Usage::

    python examples/export_policy_torch.py --ckpt logs/pendulum/model_199.pt \
        --out-dir deploy/ [--config cfg.yaml] [--env Pendulum] [--device cuda]

Produces, from one checkpoint, each checked against the live policy's
deterministic actions on the env's first observation:

- ``policy.pt2``: the ``torch.export`` program of the inference step
  (``utils/export.py`` ``export_policy``; load with ``load_policy``);
- ``policy.pt``: the state dict of the standalone fp32 module
  (``utils/torch_deploy.py`` ``as_torch_policy``), for plain torch
  pipelines;
- ``reference_state_dict.pt``: the reference layout's state dict
  (``export_torch_state_dict``) that upstream rsl_rl modules strict-load;
- ``policy.onnx``: when the ``onnx`` package is installed
  (``export_onnx``); skipped with a notice otherwise.

Runs on the CUDA device by default; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import rsl_rl_tpu_torch.env  # noqa: F401  (registers the envs)
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from rsl_rl_tpu_torch.utils.config import load_train_cfg
from rsl_rl_tpu_torch.utils.export import export_policy, load_policy
from rsl_rl_tpu_torch.utils.registry import resolve
from rsl_rl_tpu_torch.utils.torch_deploy import as_torch_policy, export_onnx, export_torch_state_dict

#: ``examples/export_policy.py``'s default config
DEFAULT_CFG = {
    "num_steps_per_env": 24,
    "save_interval": 50,
    "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
    "logger": "tensorboard",
    "policy": {
        "class_name": "ActorCritic",
        "actor_hidden_dims": [256, 256, 256],
        "critic_hidden_dims": [256, 256, 256],
        "actor_obs_normalization": True,
        "critic_obs_normalization": True,
    },
    "algorithm": {"class_name": "PPO"},
}
#: the exported programs against the live policy
ATOL = 1e-5


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--out-dir", type=str, required=True)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--env", type=str, default="Pendulum")
    parser.add_argument("--num-envs", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    cfg = load_train_cfg(args.config) if args.config else dict(DEFAULT_CFG)
    env = resolve("env", args.env)(num_envs=args.num_envs, device=args.device)
    runner = OnPolicyRunner(env, cfg, log_dir=None, device=args.device)
    runner.load(args.ckpt, load_optimizer=False)
    policy = runner.alg.policy
    _, obs = env.reset(0)
    with torch.no_grad():
        want, _ = policy.act_inference(obs, policy.initial_carry(args.num_envs))
    os.makedirs(args.out_dir, exist_ok=True)
    paths = {}

    # ---- torch.export (a program that runs without the port's classes)
    paths["program"] = os.path.join(args.out_dir, "policy.pt2")
    export_policy(policy, obs, paths["program"])
    torch.testing.assert_close(load_policy(paths["program"])(obs), want, rtol=0, atol=ATOL)
    print(f"wrote {paths['program']} (verified vs live policy)")

    # ---- the standalone module (plain torch pipelines)
    module = as_torch_policy(policy).eval()
    flat = torch.cat([obs[g] for g in module.obs_names], dim=-1)
    with torch.no_grad():
        out = module(flat)
    torch.testing.assert_close(out[0] if policy.is_recurrent else out, want, rtol=0, atol=ATOL)
    paths["module"] = os.path.join(args.out_dir, "policy.pt")
    torch.save(module.state_dict(), paths["module"])
    print(f"wrote {paths['module']} (torch module verified vs live policy)")

    # ---- the reference layout's state dict (hand back to upstream rsl_rl)
    paths["reference"] = os.path.join(args.out_dir, "reference_state_dict.pt")
    torch.save(export_torch_state_dict(policy), paths["reference"])
    print(f"wrote {paths['reference']} (strict-loads into reference modules)")

    # ---- ONNX (optional dependency)
    onnx_path = os.path.join(args.out_dir, "policy.onnx")
    try:
        export_onnx(policy, onnx_path)
        paths["onnx"] = onnx_path
        print(f"wrote {onnx_path}")
    except RuntimeError as e:
        print(f"skipped ONNX: {e}")
    return paths


if __name__ == "__main__":
    main()
