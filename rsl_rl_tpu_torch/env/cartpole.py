"""Cart-pole swing-up, continuous action (counterpart of
``rsl_rl_tpu/env/cartpole.py``): the pole starts hanging down, a horizontal
force on the cart swings it up, and the reward favours an upright pole with
the cart centred. Leaving the track (``|x| > x_limit``) is a true terminal
state (reward -10, no bootstrap); the time limit is a timeout. The reset
draws come from per-env keys in the state (``env/nlink.py``
``hash_draws``), not from JAX's threefry.
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
class CartPoleState(EnvState):
    x: torch.Tensor  # [N] cart position
    x_dot: torch.Tensor  # [N] cart velocity
    theta: torch.Tensor  # [N] pole angle (0 = upright)
    theta_dot: torch.Tensor  # [N] pole angular velocity
    rng: torch.Tensor  # [N] int64 per-env keys of the reset draws


@register("env")
class CartPoleSwingUp(VecEnv):
    """Cart-pole swing-up; the obs is ``[x, ẋ, cos θ, sin θ, θ̇]``."""

    num_actions = 1
    gravity = 9.8
    cart_mass = 1.0
    pole_mass = 0.1
    pole_half_length = 0.5
    force_mag = 10.0
    dt = 0.02
    x_limit = 2.4

    def __init__(self, num_envs: int, max_episode_length: int = 500, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.step_dt = self.dt
        self.max_episode_length = as_episode_length(max_episode_length, self.device)

    def _obs(self, s: CartPoleState) -> dict[str, torch.Tensor]:
        return {"policy": torch.stack([s.x, s.x_dot, torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)}

    def _sample_init(self, rng: torch.Tensor):
        """Each env's next key, ``x`` uniform in ``[-0.5, 0.5)`` and ``θ`` in
        ``π + [-0.1, 0.1)``."""
        rng, bits = hash_draws(rng, 2)
        return rng, uniform_draws(bits[:, 0], -0.5, 1.0), math.pi + uniform_draws(bits[:, 1], -0.1, 0.2)

    def reset(self, seed: int = 0, num_envs: int | None = None):
        num_envs = self.num_envs if num_envs is None else int(num_envs)
        check_episode_length(self.max_episode_length, num_envs)
        rng, x, theta = self._sample_init(env_keys(seed, num_envs, self.device))
        zeros = torch.zeros_like(x)
        state = CartPoleState(episode_length=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                              x=x, x_dot=zeros, theta=theta, theta_dot=zeros.clone(), rng=rng)
        return state, self._obs(state)

    def randomize_episode_length(self, state: CartPoleState) -> CartPoleState:
        return random_episode_lengths(state, self.max_episode_length)

    def step(self, state: CartPoleState, actions: torch.Tensor):
        force = torch.clamp(actions[:, 0], -1.0, 1.0) * self.force_mag
        total_mass = self.cart_mass + self.pole_mass
        ml = self.pole_mass * self.pole_half_length
        cos_t, sin_t = torch.cos(state.theta), torch.sin(state.theta)
        temp = (force + ml * state.theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.gravity * sin_t - cos_t * temp) / (
            self.pole_half_length * (4.0 / 3.0 - self.pole_mass * cos_t**2 / total_mass)
        )
        x_acc = temp - ml * theta_acc * cos_t / total_mass
        x = state.x + self.dt * state.x_dot
        x_dot = state.x_dot + self.dt * x_acc
        theta = state.theta + self.dt * state.theta_dot
        theta_dot = state.theta_dot + self.dt * theta_acc

        upright = torch.cos(theta)
        reward = upright - 0.1 * torch.abs(x) - 0.01 * torch.square(force / self.force_mag)
        episode_length = state.episode_length + 1
        time_out = episode_length >= self.max_episode_length
        terminal = torch.abs(x) > self.x_limit
        done = time_out | terminal
        reward = torch.where(terminal, reward - 10.0, reward)

        rng, reset_x, reset_theta = self._sample_init(state.rng)
        zero = torch.zeros_like(x)
        state = CartPoleState(
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            x=torch.where(done, reset_x, x),
            x_dot=torch.where(done, zero, x_dot),
            theta=torch.where(done, reset_theta, theta),
            theta_dot=torch.where(done, zero, theta_dot),
            rng=rng,
        )
        extras = {"time_outs": time_out & ~terminal,
                  "log": {"cartpole/upright": upright, "cartpole/abs_x": torch.abs(x)}}
        return state, self._obs(state), reward, done, extras
