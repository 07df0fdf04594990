"""Train the PyTorch port's PPO on an MJX-shaped simulator (``MJXEnv``), the
counterpart of ``examples/train_mjx.py``.

The cart-pole *balance* task of the JAX example (pole starts near upright,
reward for keeping it there), with the same model XML, reward, terminal and
training config, through ``OnPolicyRunner``; then the trained policy acts
deterministically for 200 steps of 256 envs (with ``--log-dir``, through a
checkpoint reloaded into a fresh runner).

MJX is a JAX library, and no torch package provides its functions, so the
simulator is named on the command line: ``--sim module:attr`` is an object
with MJX's ``put_model``, ``make_data``, ``forward`` and ``step`` on torch
tensors (see ``rsl_rl_tpu_torch/env/mjx_env.py``). Without it the script
exits with the adapter's message.

Usage::

    python examples/train_mjx_torch.py --sim my_package.mjx:sim [--num-envs 1024] [--iterations 200]
                                       [--log-dir DIR] [--device cuda]

Needs the ``mujoco`` package for the host model. Runs on the CUDA device by
default; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

# allow running from a repo checkout without installing the package
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from rsl_rl_tpu_torch.env import MJXEnv
from rsl_rl_tpu_torch.runners import OnPolicyRunner

CARTPOLE_XML = """
<mujoco model="cartpole">
  <option timestep="0.02"/>
  <worldbody>
    <body name="cart" pos="0 0 1">
      <joint name="slider" type="slide" axis="1 0 0" range="-2 2"/>
      <geom type="box" size="0.2 0.1 0.05" mass="1"/>
      <body name="pole" pos="0 0 0">
        <joint name="hinge" type="hinge" axis="0 1 0" range="-3.14 3.14"/>
        <geom type="capsule" fromto="0 0 0 0 0 0.6" size="0.04" mass="0.3"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="slider" gear="30"/></actuator>
</mujoco>
"""


def obs_fn(mx, d):
    return {"policy": torch.cat([d.qpos, d.qvel])}


def reward_fn(mx, d, a):
    upright = torch.cos(d.qpos[1])  # 1 when the pole is up
    centered = -0.05 * torch.square(d.qpos[0])
    effort = -0.001 * torch.sum(torch.square(a))
    return upright + centered + effort


def done_fn(mx, d):
    return torch.abs(d.qpos[1]) > 0.9  # pole fell


def make_env(num_envs: int, sim, device: str, episode_length: int = 500) -> MJXEnv:
    import mujoco

    model = mujoco.MjModel.from_xml_string(CARTPOLE_XML)
    return MJXEnv(model, num_envs=num_envs, episode_length=episode_length, obs_fn=obs_fn, reward_fn=reward_fn,
                  done_fn=done_fn, reset_noise_scale=0.05, sim=sim, device=device)


def train_cfg() -> dict:
    """``examples/train_mjx.py``'s config."""
    return {
        "num_steps_per_env": 24,
        "save_interval": 100,
        "seed": 1,
        "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
        "logger": "tensorboard",
        "policy": {
            "class_name": "ActorCritic",
            "activation": "elu",
            "actor_hidden_dims": [256, 256],
            "critic_hidden_dims": [256, 256],
            "actor_obs_normalization": True,
            "critic_obs_normalization": True,
        },
        "algorithm": {
            "class_name": "PPO",
            "learning_rate": 1e-3,
            "schedule": "adaptive",
            "desired_kl": 0.01,
            "gamma": 0.99,
            "lam": 0.95,
            "entropy_coef": 0.005,
        },
    }


def load_sim(spec: str | None):
    """The object ``module:attr`` names (``None`` without ``--sim``)."""
    if spec is None:
        return None
    module, _, attr = spec.partition(":")
    sim = importlib.import_module(module)
    return getattr(sim, attr) if attr else sim


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--sim", type=str, default=None, help="module:attr of an MJX-shaped simulator on torch tensors")
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    sim = load_sim(args.sim)
    try:
        env = make_env(args.num_envs, sim, args.device)
    except ImportError as err:
        sys.exit(f"train_mjx_torch.py: {err}")
    runner = OnPolicyRunner(env, train_cfg(), log_dir=args.log_dir, device=args.device)
    runner.learn(args.iterations)

    # -------- conformance: the trained policy (through a checkpoint with a log dir) acts
    if args.log_dir is not None:
        from rsl_rl_tpu_torch.utils.checkpoint import latest_checkpoint

        runner = OnPolicyRunner(make_env(args.num_envs, sim, args.device), train_cfg(), device=args.device)
        runner.load(latest_checkpoint(args.log_dir))
    policy = runner.get_inference_policy()
    eval_env = make_env(256, sim, args.device)
    state, obs = eval_env.reset(42)
    total = torch.zeros(256, device=eval_env.device)
    with torch.no_grad():
        for _ in range(200):
            state, obs, rew, done, _ = eval_env.step(state, policy(obs))
            total += rew
    mean_return = float(total.mean())
    print(f"deterministic eval return over 200 steps: {mean_return:.1f}")
    # an untrained policy scores ~<60 here (pole falls, restarts); trained
    # balance holds upright (reward ~1/step)
    print("CONFORMANCE PASS" if mean_return > 120.0 else "CONFORMANCE FAIL")


if __name__ == "__main__":
    main()
