"""Running-moment observation normalization (counterpart of
``rsl_rl_tpu/ops/running_norm.py``). The moments are buffers of a small
``nn.Module``, so they move with ``.to(device)`` and are updated in place."""

from __future__ import annotations

import torch
from torch import nn


class RunningNormState(nn.Module):
    """Empirical mean/variance normalizer state.

    Attributes:
        mean, var: running mean and (biased) variance, ``[dim]``.
        count: samples folded in so far (float32 scalar).
        until: updates stop once ``count >= until``; ``None`` never freezes.
        eps: added to the std in :func:`normalize`.
    """

    def __init__(self, dim: int, eps: float = 1e-2, until: float | None = None):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim, dtype=torch.float32))
        self.register_buffer("var", torch.ones(dim, dtype=torch.float32))
        self.register_buffer("count", torch.zeros((), dtype=torch.float32))
        self.until = None if until is None else float(until)
        self.eps = eps

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var)


def normalize(state: RunningNormState, x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) / (std + eps)``."""
    return (x - state.mean) / (state.std + state.eps)


@torch.no_grad()
def update_running_norm(state: RunningNormState, x: torch.Tensor) -> RunningNormState:
    """Fold a batch into the moments, in place; returns ``state``.

    ``rate = B / n`` with the new total ``n``:
    ``mean' = mean + rate * (mean_x - mean)`` and
    ``var' = var + rate * (var_x - var + delta * (mean_x - mean'))``.
    The freeze test uses the count before the update (``until=0`` freezes
    from the start). All leading axes of ``x`` are batch axes.
    """
    batch_axes = tuple(range(x.ndim - state.mean.ndim))
    count_x = 1
    for ax in batch_axes:
        count_x *= x.shape[ax]
    new_count = state.count + count_x
    rate = count_x / new_count
    mean_x = torch.mean(x, dim=batch_axes)
    var_x = torch.var(x, dim=batch_axes, unbiased=False)
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
