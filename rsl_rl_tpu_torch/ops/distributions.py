"""Diagonal-Gaussian policy distribution math (counterpart of
``rsl_rl_tpu/ops/distributions.py``). Arrays are ``[..., A]``; log-prob and
entropy sum the action dimension."""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def sample(
    mean: torch.Tensor,
    std: torch.Tensor,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Reparameterized sample ``mean + std * noise``.

    ``noise`` defaults to a standard normal draw from ``generator``; passing
    it lets a caller replay the noise of another implementation.
    """
    if noise is None:
        noise = torch.randn(
            mean.shape, dtype=mean.dtype, device=mean.device, generator=generator
        )
    return mean + std * noise


def log_prob(mean: torch.Tensor, std: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``Normal(mean, std).log_prob(value).sum(-1)``."""
    z = (value - mean) / std
    per_dim = -0.5 * torch.square(z) - torch.log(std) - _LOG_SQRT_2PI
    return torch.sum(per_dim, dim=-1)


def entropy(std: torch.Tensor) -> torch.Tensor:
    """``Normal(...).entropy().sum(-1)``."""
    return torch.sum(0.5 + _LOG_SQRT_2PI + torch.log(std), dim=-1)


def kl_divergence(
    old_mean: torch.Tensor,
    old_std: torch.Tensor,
    new_mean: torch.Tensor,
    new_std: torch.Tensor,
    eps: float = 1.0e-5,
) -> torch.Tensor:
    """Analytic KL(old || new) summed over actions, with the reference's
    ``+ 1e-5`` inside the log."""
    per_dim = (
        torch.log(new_std / old_std + eps)
        + (torch.square(old_std) + torch.square(old_mean - new_mean))
        / (2.0 * torch.square(new_std))
        - 0.5
    )
    return torch.sum(per_dim, dim=-1)
