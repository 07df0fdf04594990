"""Vectorized environment contract (counterpart of ``rsl_rl_tpu/env/vec_env.py``).

The env is a state machine over tensors that live on one device:

- ``reset(seed) -> (state, obs)``
- ``step(state, actions) -> (state, obs, rewards, dones, extras)``

Observations are a dict of named groups; ``extras["time_outs"]`` marks
time-limit truncations (value bootstrap) and ``extras["log"]`` carries per-env
scalars. Environments auto-reset: where ``dones[i]`` is set, the returned obs
of env ``i`` is the first observation of a fresh episode. The random draws of
those resets come from a ``torch.Generator`` the env owns, seeded by
``reset``; they differ from the JAX package's threefry draws for the same seed.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

import torch


@dataclass
class EnvState:
    """Base env state: every field carries a leading ``num_envs`` axis.

    Attributes:
        episode_length: Current episode step counts, ``[num_envs]`` int32.
    """

    episode_length: torch.Tensor


def as_episode_length(value, device: torch.device | str = "cpu") -> int | torch.Tensor:
    """Normalize a ``max_episode_length`` config value: ints stay ints, any
    sequence becomes a per-env ``[num_envs]`` int32 tensor."""
    if isinstance(value, int):
        return value
    return torch.as_tensor(value, dtype=torch.int32, device=device)


class VecEnv(abc.ABC):
    """Abstract vectorized environment on one torch device."""

    num_envs: int
    num_actions: int
    max_episode_length: int | torch.Tensor
    device: torch.device

    @abc.abstractmethod
    def reset(self, seed: int) -> tuple[EnvState, dict[str, torch.Tensor]]:
        """Seed the env's generator and initialize all envs."""

    @abc.abstractmethod
    def step(
        self, state: EnvState, actions: torch.Tensor
    ) -> tuple[EnvState, dict[str, torch.Tensor], torch.Tensor, torch.Tensor, dict]:
        """Step all envs: ``(state, obs, rewards [N], dones [N] bool, extras)``."""
