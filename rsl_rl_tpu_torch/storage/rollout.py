"""Rollout storage (counterpart of ``rsl_rl_tpu/storage/rollout.py``).

A rollout is one collection window, time-major ``[T, N, ...]`` (multi-seed
training stacks G of them, ``[G, T, N, ...]``, carries ``[G, N, ...]``). Recurrent
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
    """``rewards`` already include the timeout value bootstrap. PPO fills
    ``values``, ``log_probs``, ``mu`` and ``sigma``; distillation fills
    ``privileged_actions``, the teacher's actions."""

    obs: dict[str, torch.Tensor]
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor | None = None
    log_probs: torch.Tensor | None = None
    mu: torch.Tensor | None = None
    sigma: torch.Tensor | None = None
    privileged_actions: torch.Tensor | None = None
    carry0: Any = None  # policy carry entering step 0

    @property
    def num_steps(self) -> int:
        return self.dones.shape[-2]

    @property
    def num_envs(self) -> int:
        return self.dones.shape[-1]

    def replay_resets(self) -> torch.Tensor:
        """``resets[t] = dones[t-1]``, ``resets[0] = False`` (per seed)."""
        return torch.cat([torch.zeros_like(self.dones[..., :1, :]), self.dones[..., :-1, :]], dim=-2)


def recurrent_minibatch_starts(num_envs: int, num_mini_batches: int, num_epochs: int) -> list[int]:
    """Env-slice start offsets of every minibatch of every epoch, in order."""
    mb = num_envs // num_mini_batches
    return [i * mb for i in range(num_mini_batches)] * num_epochs


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every tensor of a nested dict/tuple/list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def slice_envs(tree: Any, start: int, size: int, axis: int = 1) -> Any:
    """Slice the env axis of every tensor in a nested dict/tuple (a view)."""
    return tree_map(lambda t: t.narrow(axis, start, size), tree)
