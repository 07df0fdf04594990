"""Point mass (counterpart of ``PointMass`` and ``point_mass_symmetry`` of
``rsl_rl_tpu/env/toy.py``): a 1-D mass driven to rest at the origin, with a
true terminal state (leaving ``|x| > bound``) beside the time limit, and
mirror-symmetric dynamics and reward. The reset draws come from per-env keys
in the state (``env/nlink.py`` ``hash_draws``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rsl_rl_tpu_torch.env.nlink import env_keys, hash_draws, random_episode_lengths, uniform_draws
from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv, as_episode_length, check_episode_length
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import register


@dataclass
class PointMassState(EnvState):
    x: torch.Tensor  # [N] position
    v: torch.Tensor  # [N] velocity
    rng: torch.Tensor  # [N] int64 per-env keys of the reset draws


@register("env")
class PointMass(VecEnv):
    """1-D point mass: drive position and velocity to zero.

    ``"policy"`` sees ``[x, v]``, ``"privileged"`` also the last action
    (zero on a fresh episode). Leaving ``|x| > bound`` terminates (no
    bootstrap); the time limit is a timeout.
    """

    num_actions = 1
    dt = 0.1
    bound = 5.0

    def __init__(self, num_envs: int, max_episode_length: int = 100, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.step_dt = self.dt
        self.max_episode_length = as_episode_length(max_episode_length, self.device)

    def _obs(self, state: PointMassState, last_action: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        if last_action is None:
            last_action = torch.zeros_like(state.x)
        return {"policy": torch.stack([state.x, state.v], dim=-1),
                "privileged": torch.stack([state.x, state.v, last_action], dim=-1)}

    def reset(self, seed: int = 0, num_envs: int | None = None, env_offset: int = 0):
        num_envs = self.num_envs if num_envs is None else int(num_envs)
        check_episode_length(self.max_episode_length, num_envs)
        rng, bits = hash_draws(env_keys(seed, num_envs, self.device, env_offset), 1)
        x = uniform_draws(bits[:, 0], -2.0, 4.0)
        state = PointMassState(episode_length=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                               x=x, v=torch.zeros_like(x), rng=rng)
        return state, self._obs(state)

    def randomize_episode_length(self, state: PointMassState) -> PointMassState:
        return random_episode_lengths(state, self.max_episode_length)

    def step(self, state: PointMassState, actions: torch.Tensor):
        a = torch.clamp(actions[:, 0], -1.0, 1.0)
        v = state.v + a * self.dt
        x = state.x + v * self.dt
        reward = -(x**2 + 0.1 * v**2 + 0.01 * a**2)

        episode_length = state.episode_length + 1
        time_out = episode_length >= self.max_episode_length
        terminal = torch.abs(x) > self.bound
        done = time_out | terminal
        rng, bits = hash_draws(state.rng, 1)
        zero = torch.zeros_like(x)
        state = PointMassState(
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            x=torch.where(done, uniform_draws(bits[:, 0], -2.0, 4.0), x),
            v=torch.where(done, zero, v),
            rng=rng,
        )
        extras = {"time_outs": time_out & ~terminal, "log": {"pointmass/abs_x": torch.abs(x)}}
        return state, self._obs(state, torch.where(done, zero, a)), reward, done, extras


def point_mass_symmetry(obs=None, actions=None, env=None):
    """Symmetry augmentation for :class:`PointMass`, whose dynamics and reward
    are invariant under ``(x, v, a) -> (-x, -v, -a)``: the batch stacked with
    its mirrored copy along the leading axis (the original first), for
    whichever of ``obs`` / ``actions`` is given."""
    obs_aug = None if obs is None else {k: torch.cat([v, -v], dim=0) for k, v in obs.items()}
    actions_aug = None if actions is None else torch.cat([actions, -actions], dim=0)
    return obs_aug, actions_aug
