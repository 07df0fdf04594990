"""Pendulum swing-up (counterpart of ``rsl_rl_tpu/env/pendulum.py``):
Gymnasium ``Pendulum-v1``'s dynamics and reward. Episodes end by time limit
only, so every done is a timeout. The reset draws come from per-env keys in
the state, as in :mod:`rsl_rl_tpu_torch.env.nlink` (``hash_draws``), not
from JAX's threefry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from rsl_rl_tpu_torch.env.nlink import env_keys, hash_draws, random_episode_lengths, uniform_draws
from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv, as_episode_length, check_episode_length
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import register


@dataclass
class PendulumState(EnvState):
    theta: torch.Tensor  # [N] angle (0 = upright)
    theta_dot: torch.Tensor  # [N] angular velocity
    rng: torch.Tensor  # [N] int64 per-env keys of the reset draws


@register("env")
class Pendulum(VecEnv):
    """Classic pendulum swing-up, vectorized over ``num_envs``; the obs is
    ``[cos θ, sin θ, θ̇]``."""

    num_actions = 1
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    def __init__(self, num_envs: int, max_episode_length: int = 200, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.step_dt = self.dt
        self.max_episode_length = as_episode_length(max_episode_length, self.device)

    def _obs(self, state: PendulumState) -> dict[str, torch.Tensor]:
        return {"policy": torch.stack([torch.cos(state.theta), torch.sin(state.theta), state.theta_dot], dim=-1)}

    def _sample_init(self, rng: torch.Tensor):
        """Each env's next key, θ uniform in ``[-π, π)`` and θ̇ in ``[-1, 1)``."""
        rng, bits = hash_draws(rng, 2)
        return rng, uniform_draws(bits[:, 0], -math.pi, 2 * math.pi), uniform_draws(bits[:, 1], -1.0, 2.0)

    def reset(self, seed: int = 0, num_envs: int | None = None, env_offset: int = 0):
        num_envs = self.num_envs if num_envs is None else int(num_envs)
        check_episode_length(self.max_episode_length, num_envs)
        rng, theta, theta_dot = self._sample_init(env_keys(seed, num_envs, self.device, env_offset))
        state = PendulumState(episode_length=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                              theta=theta, theta_dot=theta_dot, rng=rng)
        return state, self._obs(state)

    def randomize_episode_length(self, state: PendulumState) -> PendulumState:
        return random_episode_lengths(state, self.max_episode_length)

    def step(self, state: PendulumState, actions: torch.Tensor):
        u = torch.clamp(actions[:, 0], -self.max_torque, self.max_torque)
        theta, theta_dot = state.theta, state.theta_dot
        angle_norm = ((theta + math.pi) % (2 * math.pi)) - math.pi
        costs = angle_norm**2 + 0.1 * theta_dot**2 + 0.001 * u**2
        new_theta_dot = theta_dot + (
            3.0 * self.g / (2.0 * self.length) * torch.sin(theta) + 3.0 / (self.m * self.length**2) * u
        ) * self.dt
        new_theta_dot = torch.clamp(new_theta_dot, -self.max_speed, self.max_speed)
        new_theta = theta + new_theta_dot * self.dt

        episode_length = state.episode_length + 1
        done = episode_length >= self.max_episode_length  # time limit only
        rng, reset_theta, reset_theta_dot = self._sample_init(state.rng)
        state = PendulumState(
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            theta=torch.where(done, reset_theta, new_theta),
            theta_dot=torch.where(done, reset_theta_dot, new_theta_dot),
            rng=rng,
        )
        extras = {"time_outs": done, "log": {"pendulum/abs_angle": torch.abs(angle_norm)}}
        return state, self._obs(state), -costs, done, extras


@register("env")
class PartiallyObservablePendulum(Pendulum):
    """Pendulum without the velocity: the obs is ``[cos θ, sin θ]``."""

    def _obs(self, state: PendulumState) -> dict[str, torch.Tensor]:
        return {"policy": torch.stack([torch.cos(state.theta), torch.sin(state.theta)], dim=-1)}


@register("env")
class PrivilegedPendulum(Pendulum):
    """Teacher-student pendulum: ``"policy"`` is ``[cos θ, sin θ]``,
    ``"privileged"`` adds θ̇."""

    def _obs(self, state: PendulumState) -> dict[str, torch.Tensor]:
        cos, sin = torch.cos(state.theta), torch.sin(state.theta)
        return {"policy": torch.stack([cos, sin], dim=-1),
                "privileged": torch.stack([cos, sin, state.theta_dot], dim=-1)}
