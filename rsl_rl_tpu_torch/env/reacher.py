"""Two-joint planar reacher (counterpart of ``rsl_rl_tpu/env/reacher.py``):
torque-controlled revolute joints drive the arm's tip to a target drawn
each episode, with a dense negative-distance reward and an action penalty.
``"policy"`` sees the joints and the target offset, ``"privileged"`` also
the joint velocities unscaled. Episodes end by time limit only. The reset
draws come from per-env keys in the state (``env/nlink.py``
``hash_draws``).
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
class ReacherState(EnvState):
    q: torch.Tensor  # [N, 2] joint angles
    qd: torch.Tensor  # [N, 2] joint velocities
    target: torch.Tensor  # [N, 2] target xy
    rng: torch.Tensor  # [N] int64 per-env keys of the reset draws


@register("env")
class Reacher(VecEnv):
    """Planar 2-link reacher with torque control."""

    num_actions = 2
    dt = 0.05
    damping = 0.9
    link = (0.5, 0.5)
    max_torque = 1.0

    def __init__(self, num_envs: int, max_episode_length: int = 150, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.step_dt = self.dt
        self.max_episode_length = as_episode_length(max_episode_length, self.device)

    def _tip(self, q: torch.Tensor) -> torch.Tensor:
        l1, l2 = self.link
        x = l1 * torch.cos(q[:, 0]) + l2 * torch.cos(q[:, 0] + q[:, 1])
        y = l1 * torch.sin(q[:, 0]) + l2 * torch.sin(q[:, 0] + q[:, 1])
        return torch.stack([x, y], dim=-1)

    def _obs(self, state: ReacherState) -> dict[str, torch.Tensor]:
        policy = torch.cat([torch.cos(state.q), torch.sin(state.q), state.qd * 0.1,
                            state.target - self._tip(state.q)], dim=-1)
        return {"policy": policy, "privileged": torch.cat([policy, state.qd], dim=-1)}

    def _sample(self, rng: torch.Tensor):
        """Each env's next key, ``q`` uniform in ``[-π, π)²`` and a target at
        a radius in ``[0.3, 0.9)`` and an angle in ``[-π, π)``."""
        rng, bits = hash_draws(rng, 4)
        q = uniform_draws(bits[:, :2], -math.pi, 2 * math.pi)
        radius = uniform_draws(bits[:, 2:3], 0.3, 0.6)
        angle = uniform_draws(bits[:, 3:4], -math.pi, 2 * math.pi)
        return rng, q, torch.cat([radius * torch.cos(angle), radius * torch.sin(angle)], dim=-1)

    def reset(self, seed: int = 0, num_envs: int | None = None):
        num_envs = self.num_envs if num_envs is None else int(num_envs)
        check_episode_length(self.max_episode_length, num_envs)
        rng, q, target = self._sample(env_keys(seed, num_envs, self.device))
        state = ReacherState(episode_length=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                             q=q, qd=torch.zeros_like(q), target=target, rng=rng)
        return state, self._obs(state)

    def randomize_episode_length(self, state: ReacherState) -> ReacherState:
        return random_episode_lengths(state, self.max_episode_length)

    def step(self, state: ReacherState, actions: torch.Tensor):
        tau = torch.clamp(actions, -self.max_torque, self.max_torque)
        qd = state.qd * self.damping + tau * self.dt * 10.0
        q = state.q + qd * self.dt
        dist = torch.linalg.vector_norm(self._tip(q) - state.target, dim=-1)
        reward = -dist - 0.01 * torch.sum(torch.square(tau), dim=-1)

        episode_length = state.episode_length + 1
        done = episode_length >= self.max_episode_length  # a fixed horizon
        rng, reset_q, reset_target = self._sample(state.rng)
        d = done[:, None]
        state = ReacherState(
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            q=torch.where(d, reset_q, q),
            qd=torch.where(d, torch.zeros_like(qd), qd),
            target=torch.where(d, reset_target, state.target),
            rng=rng,
        )
        extras = {"time_outs": done, "log": {"reacher/tip_distance": dist}}
        return state, self._obs(state), reward, done, extras
