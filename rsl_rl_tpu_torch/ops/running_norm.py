"""Running-moment normalization (counterpart of
``rsl_rl_tpu/ops/running_norm.py``): the observation normalizer and the
RND reward normalizer. The moments are buffers of a small ``nn.Module``, so
they move with ``.to(device)`` and are updated in place. Multi-seed training
stacks each seed's moments and updates them under ``torch.func.vmap``
(``modules.policy.seed_call``), per seed. Under data parallelism a
normalizer's ``mesh`` (``parallel/mesh.py``) makes its update fold in the
moments of the global batch, summed over the data group, so the moments stay
the same on every rank and equal one process's over the whole batch."""

from __future__ import annotations

import torch
from torch import nn


class RunningNormState(nn.Module):
    """Empirical mean/variance normalizer state.

    Attributes:
        mean, var: running mean and (biased) variance, ``[dim]`` (``dim``
            may be a shape, ``()`` for a scalar stream).
        count: samples folded in so far (float32 scalar).
        until: updates stop once ``count >= until``; ``None`` never freezes.
        eps: added to the std in :func:`normalize`.
    """

    def __init__(self, dim: int | tuple, eps: float = 1e-2, until: float | None = None):
        super().__init__()
        shape = (dim,) if isinstance(dim, int) else tuple(dim)
        self.register_buffer("mean", torch.zeros(shape, dtype=torch.float32))
        self.register_buffer("var", torch.ones(shape, dtype=torch.float32))
        self.register_buffer("count", torch.zeros((), dtype=torch.float32))
        self.until = None if until is None else float(until)
        self.eps = eps
        #: the mesh whose data group the batch moments are summed over; None:
        #: this process's batch is the whole batch
        self.mesh = None

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var)


def normalize(state: RunningNormState, x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) / (std + eps)``."""
    return (x - state.mean) / (state.std + state.eps)


def denormalize(state: RunningNormState, y: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`normalize`: ``y * (std + eps) + mean``."""
    return y * (state.std + state.eps) + state.mean


@torch.no_grad()
def update_running_norm(state: RunningNormState, x: torch.Tensor) -> RunningNormState:
    """Fold a batch into the moments, in place; returns ``state``.

    ``rate = B / n`` with the new total ``n``:
    ``mean' = mean + rate * (mean_x - mean)`` and
    ``var' = var + rate * (var_x - var + delta * (mean_x - mean'))``.
    The freeze test uses the count before the update (``until=0`` freezes
    from the start). All leading axes of ``x`` are batch axes. With a
    ``state.mesh`` the batch is the data group's (:func:`_global_moments`).
    """
    batch_axes = tuple(range(x.ndim - state.mean.ndim))
    count_x = 1
    for ax in batch_axes:
        count_x *= x.shape[ax]
    if state.mesh is None:
        mean_x = torch.mean(x, dim=batch_axes)
        var_x = torch.var(x, dim=batch_axes, unbiased=False)
    else:
        count_x, mean_x, var_x = _global_moments(x, batch_axes, count_x, state.mesh)
    new_count = state.count + count_x
    rate = count_x / new_count
    delta = mean_x - state.mean
    new_mean = state.mean + rate * delta
    new_var = state.var + rate * (var_x - state.var + delta * (mean_x - new_mean))
    if state.until is None:
        state.mean.copy_(new_mean)
        state.var.copy_(new_var)
        state.count.copy_(new_count)
    else:
        # decided on the device: no host sync inside the collect loop
        frozen = state.count >= state.until
        state.mean.copy_(torch.where(frozen, state.mean, new_mean))
        state.var.copy_(torch.where(frozen, state.var, new_var))
        state.count.copy_(torch.where(frozen, state.count, new_count))
    return state


def _global_moments(x: torch.Tensor, batch_axes: tuple, count_x: int, mesh):
    """``(count, mean, biased var)`` of the data group's batch, its shards of
    equal size: each rank's moments weighted by ``1 / data_size``, two sums
    (on a group of one exactly the rank's own)."""
    w = 1.0 / mesh.data_size
    mean_i = torch.mean(x, dim=batch_axes)
    var_i = torch.var(x, dim=batch_axes, unbiased=False)
    mean = mesh.data_sum_(mean_i * w)
    var = mesh.data_sum_((var_i + torch.square(mean_i - mean)) * w)
    return count_x * mesh.data_size, mean, var


class DiscountedVariationNormState(nn.Module):
    """Reward normalization by the std of the discounted return (the RND
    reward normalizer): a per-env accumulator ``avg = gamma * avg + r``
    feeds the scalar running normalizer ``emp``, whose std divides the
    reward."""

    def __init__(self, num_envs: int, gamma: float = 0.99, eps: float = 1e-2, until: float | None = None):
        super().__init__()
        self.emp = RunningNormState((), eps=eps, until=until)
        self.register_buffer("avg", torch.zeros(num_envs, dtype=torch.float32))
        self.gamma = gamma


@torch.no_grad()
def normalize_reward(state: DiscountedVariationNormState, rew: torch.Tensor, update: bool = True) -> torch.Tensor:
    """Update the accumulator and the moments in place (with ``update``),
    then divide the reward by the current std where it is positive (no mean
    subtraction, no eps)."""
    if update:
        state.avg.copy_(state.avg * state.gamma + rew)
        update_running_norm(state.emp, state.avg)
    std = state.emp.std
    return torch.where(std > 0, rew / torch.where(std > 0, std, torch.ones_like(std)), rew)
