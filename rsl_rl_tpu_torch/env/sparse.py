"""Sparse-reward goal reaching (counterpart of ``rsl_rl_tpu/env/sparse.py``),
the exploration task of the RND benchmark: a 2-D point mass earns reward 1
only inside a small goal region far from its start, so plain PPO has no
signal until an episode stumbles into the goal. Reaching the goal is a true
terminal state; otherwise episodes truncate at the time limit. The reset
draws come from per-env keys in the state (``env/nlink.py`` ``hash_draws``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rsl_rl_tpu_torch.env.nlink import env_keys, hash_draws, random_episode_lengths, uniform_draws
from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv, as_episode_length, check_episode_length
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import register


@dataclass
class SparseGoalState(EnvState):
    pos: torch.Tensor  # [N, 2]
    vel: torch.Tensor  # [N, 2]
    rng: torch.Tensor  # [N] int64 per-env keys of the reset draws


@register("env")
class SparseGoalReach(VecEnv):
    """2-D point mass; reward 1 within ``goal_radius`` of the goal at
    ``(goal_dist, goal_dist)``, else 0. The obs is ``[pos, vel]``; starts
    are drawn in ``[-0.5, 0.5)²``."""

    num_actions = 2
    dt = 0.1
    damping = 0.95

    def __init__(self, num_envs: int, max_episode_length: int = 120, goal_dist: float = 3.0,
                 goal_radius: float = 0.5, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.step_dt = self.dt
        self.max_episode_length = as_episode_length(max_episode_length, self.device)
        self.goal = torch.tensor([goal_dist, goal_dist], dtype=torch.float32, device=self.device)
        self.goal_radius = goal_radius

    def _obs(self, state: SparseGoalState) -> dict[str, torch.Tensor]:
        return {"policy": torch.cat([state.pos, state.vel], dim=-1)}

    def _sample_start(self, rng: torch.Tensor):
        rng, bits = hash_draws(rng, 2)
        return rng, uniform_draws(bits, -0.5, 1.0)

    def reset(self, seed: int = 0, num_envs: int | None = None):
        num_envs = self.num_envs if num_envs is None else int(num_envs)
        check_episode_length(self.max_episode_length, num_envs)
        rng, pos = self._sample_start(env_keys(seed, num_envs, self.device))
        state = SparseGoalState(episode_length=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                                pos=pos, vel=torch.zeros_like(pos), rng=rng)
        return state, self._obs(state)

    def randomize_episode_length(self, state: SparseGoalState) -> SparseGoalState:
        return random_episode_lengths(state, self.max_episode_length)

    def step(self, state: SparseGoalState, actions: torch.Tensor):
        a = torch.clamp(actions, -1.0, 1.0)
        vel = state.vel * self.damping + a * self.dt
        pos = state.pos + vel * self.dt
        reached = torch.linalg.vector_norm(pos - self.goal, dim=-1) < self.goal_radius
        reward = reached.to(torch.float32)  # sparse: 1 at the goal, else 0

        episode_length = state.episode_length + 1
        time_out = episode_length >= self.max_episode_length
        done = reached | time_out
        rng, reset_pos = self._sample_start(state.rng)
        d = done[:, None]
        state = SparseGoalState(
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            pos=torch.where(d, reset_pos, pos),
            vel=torch.where(d, torch.zeros_like(vel), vel),
            rng=rng,
        )
        extras = {"time_outs": time_out & ~reached, "log": {"sparse_goal/success": reward}}
        return state, self._obs(state), reward, done, extras
