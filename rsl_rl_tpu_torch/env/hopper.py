"""Vertical hopper with spring-damper ground contact (counterpart of
``rsl_rl_tpu/env/hopper.py``).

A point-mass body rides a massless springy leg. With the foot on the ground
(``z < l0``) the leg pushes as a stiff spring-damper plus the agent's
thrust, and only pushes (a unilateral contact force):

    F_leg = max(k (l0 − z) − c ż + thrust, 0)  in contact, else 0
    z̈     = F_leg / m − g

integrated with semi-implicit Euler over ``n_substeps`` substeps (the stiff
contact is what makes the substeps necessary). The reward pays the height
above the rest length every step and charges the thrust. Episodes end by
time limit only. The substeps are a fixed Python loop of elementwise ops
with no host reads or data-dependent branches, so a step captures into a
CUDA graph. The reset draws come from per-env keys in the state
(``env/nlink.py`` ``hash_draws``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rsl_rl_tpu_torch.env.nlink import env_keys, hash_draws, random_episode_lengths, uniform_draws
from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv, as_episode_length, check_episode_length
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import register


@dataclass
class HopperState(EnvState):
    z: torch.Tensor  # [N] body height
    v: torch.Tensor  # [N] vertical velocity
    rng: torch.Tensor  # [N] int64 per-env keys of the reset draws


@register("env")
class Hopper(VecEnv):
    """1-DoF vertical hopper: learn the stance-phase thrust timing to bounce.
    The obs is ``[z / z_max, 0.1 ż, contact]``."""

    num_actions = 1
    g = 9.81
    mass = 1.0
    l0 = 1.0  # rest leg length, the contact height
    k = 2000.0  # leg stiffness
    c = 4.0  # leg damping
    max_thrust = 40.0
    dt = 0.02
    n_substeps = 10
    z_max = 3.0  # the reward's height scale

    def __init__(self, num_envs: int, max_episode_length: int = 200, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.step_dt = self.dt
        self.max_episode_length = as_episode_length(max_episode_length, self.device)

    def _substep(self, z, v, thrust, h):
        contact = z < self.l0
        f_leg = self.k * (self.l0 - z) - self.c * v + thrust
        f = torch.where(contact, torch.clamp(f_leg, min=0.0), torch.zeros_like(f_leg))
        v = v + h * (f / self.mass - self.g)
        z = torch.clamp(z + h * v, min=0.1)  # a floor for the body
        return z, v

    def _obs(self, state: HopperState) -> dict[str, torch.Tensor]:
        contact = (state.z < self.l0).to(torch.float32)
        return {"policy": torch.stack([state.z / self.z_max, 0.1 * state.v, contact], dim=-1)}

    def _sample_init(self, rng: torch.Tensor):
        """Each env's next key and a height in ``l0 + [0, 0.3)`` (at rest)."""
        rng, bits = hash_draws(rng, 1)
        z = self.l0 + uniform_draws(bits[:, 0], 0.0, 0.3)
        return rng, z, torch.zeros_like(z)

    def reset(self, seed: int = 0, num_envs: int | None = None, env_offset: int = 0):
        num_envs = self.num_envs if num_envs is None else int(num_envs)
        check_episode_length(self.max_episode_length, num_envs)
        rng, z, v = self._sample_init(env_keys(seed, num_envs, self.device, env_offset))
        state = HopperState(episode_length=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                            z=z, v=v, rng=rng)
        return state, self._obs(state)

    def randomize_episode_length(self, state: HopperState) -> HopperState:
        return random_episode_lengths(state, self.max_episode_length)

    def step(self, state: HopperState, actions: torch.Tensor):
        thrust = torch.clamp(actions[:, 0], 0.0, 1.0) * self.max_thrust
        z, v = state.z, state.v
        h = self.dt / self.n_substeps
        for _ in range(self.n_substeps):
            z, v = self._substep(z, v, thrust, h)
        reward = (z - self.l0) / (self.z_max - self.l0) - 0.02 * (thrust / self.max_thrust) ** 2

        episode_length = state.episode_length + 1
        done = episode_length >= self.max_episode_length  # time limit only
        rng, reset_z, reset_v = self._sample_init(state.rng)
        state = HopperState(
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            z=torch.where(done, reset_z, z),
            v=torch.where(done, reset_v, v),
            rng=rng,
        )
        extras = {"time_outs": done,
                  "log": {"hopper/height": z, "hopper/contact": (z < self.l0).to(torch.float32)}}
        return state, self._obs(state), reward, done, extras
