"""Rollout storage (counterpart of ``rsl_rl_tpu/storage/rollout.py``).

A rollout is one collection window, time-major ``[T, N, ...]``. Recurrent
rollouts keep only the window-start carry ``carry0``: trajectories that start
mid-window begin from a zeroed carry, which the replay reproduces from
``resets[t] = dones[t-1]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class Rollout:
    """``rewards`` already include the timeout value bootstrap."""

    obs: dict[str, torch.Tensor]
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_probs: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    carry0: Any = None  # policy carry entering step 0 (recurrent only)

    @property
    def num_steps(self) -> int:
        return self.dones.shape[0]

    @property
    def num_envs(self) -> int:
        return self.dones.shape[1]

    def replay_resets(self) -> torch.Tensor:
        """``resets[t] = dones[t-1]``, ``resets[0] = False``."""
        return torch.cat([torch.zeros_like(self.dones[:1]), self.dones[:-1]], dim=0)


def recurrent_minibatch_starts(num_envs: int, num_mini_batches: int, num_epochs: int) -> list[int]:
    """Env-slice start offsets of every minibatch of every epoch, in order."""
    mb = num_envs // num_mini_batches
    return [i * mb for i in range(num_mini_batches)] * num_epochs


def slice_envs(tree: Any, start: int, size: int, axis: int = 1) -> Any:
    """Slice the env axis of every tensor in a nested dict/tuple (a view)."""
    if isinstance(tree, dict):
        return {k: slice_envs(v, start, size, axis) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(slice_envs(v, start, size, axis) for v in tree)
    return tree.narrow(axis, start, size)
