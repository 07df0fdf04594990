"""Split, pad and unpad trajectories (counterpart of
``rsl_rl_tpu/utils/trajectories.py``, the upstream reference's
``split_and_pad_trajectories`` / ``unpad_trajectories``).

The training path does not use them (the recurrent replay zeroes the carry
at resets instead of padding trajectories); they serve offline analysis of
a rollout. The padded output has the JAX package's static width ``N * T``
trajectories, the real ones in the leading columns in the reference's order
(env-major, then time) and the rest masked out, so the two packages give
the same arrays.
"""

from __future__ import annotations

from typing import Any

import torch

from rsl_rl_tpu_torch.storage.rollout import tree_map


def split_and_pad_trajectories(tensor: Any, dones: torch.Tensor) -> tuple[Any, torch.Tensor]:
    """Split a time-major rollout at its dones and zero-pad the trajectories.

    The last step of every env ends a trajectory, so each env's window is
    covered.

    Args:
        tensor: ``[T, N, ...]`` tensor, or a dict (or tuple) of them.
        dones: ``[T, N]`` done flags (bool or numeric).

    Returns:
        ``(padded, mask)``: ``padded`` is ``[T, N*T, ...]`` with one
        trajectory a column, ``mask`` ``[T, N*T]`` bool marks the valid steps.
    """
    dones = torch.as_tensor(dones).to(torch.bool)
    T, N = dones.shape
    device = dones.device
    d = dones.T.clone()  # [N, T]
    d[:, -1] = True  # a forced done at the window's end
    steps = torch.arange(T, device=device)
    trajs_per_env = d.sum(dim=1)
    env_offset = torch.cumsum(trajs_per_env, 0) - trajs_per_env
    prev_dones = torch.cumsum(d.to(torch.int64), dim=1) - d.to(torch.int64)
    traj_id = prev_dones + env_offset[:, None]
    # the most recent done strictly before each step (-1 if none)
    marks = torch.where(d, steps, -1)
    last_done = torch.cat([torch.full((N, 1), -1, device=device, dtype=marks.dtype),
                           torch.cummax(marks, dim=1).values[:, :-1]], dim=1)
    pos = steps[None, :] - last_done - 1
    flat_traj, flat_pos = traj_id.reshape(-1), pos.reshape(-1)

    def scatter(x: torch.Tensor) -> torch.Tensor:
        flat = x.transpose(0, 1).reshape((N * T,) + tuple(x.shape[2:]))
        out = torch.zeros((T, N * T) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        out[flat_pos, flat_traj] = flat
        return out

    return tree_map(scatter, tensor), scatter(torch.ones(T, N, dtype=torch.bool, device=device))


def unpad_trajectories(trajectories: Any, masks: torch.Tensor) -> Any:
    """The inverse of :func:`split_and_pad_trajectories`: ``[T, N, ...]``
    again. ``masks`` must come from it (width ``N * T``), which gives ``N``."""
    T, J = masks.shape
    if J % T != 0:
        raise ValueError(f"masks must come from split_and_pad_trajectories (width N*T); got T={T}, width={J}")
    N = J // T
    flat_mask = masks.T.reshape(-1)  # trajectory-major
    order = torch.argsort((~flat_mask).to(torch.int8), stable=True)  # valid rows first, in order

    def gather(x: torch.Tensor) -> torch.Tensor:
        flat = x.transpose(0, 1).reshape((J * T,) + tuple(x.shape[2:]))
        valid = flat[order[: N * T]]  # exactly N*T valid steps, env-major
        return valid.reshape((N, T) + tuple(x.shape[2:])).transpose(0, 1)

    return tree_map(gather, trajectories)
