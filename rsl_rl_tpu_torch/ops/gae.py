"""Generalized Advantage Estimation (counterpart of ``rsl_rl_tpu/ops/gae.py``),
as the reference's reverse loop over the window."""

from __future__ import annotations

import torch


def compute_gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_values: torch.Tensor,
    gamma: float,
    lam: float,
    normalize_advantage: bool = True,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step returns and advantages over a ``[T, N]`` window.

    ``delta_t = r_t + (1 - done_t) γ V_{t+1} - V_t``,
    ``A_t = delta_t + (1 - done_t) γ λ A_{t+1}``, ``R_t = A_t + V_t``; the
    advantages are optionally whitened with the unbiased std, the returns
    stay raw. Timeout bootstraps are already folded into ``rewards``.
    """
    not_terminal = 1.0 - dones.to(values.dtype)
    advantages = torch.empty_like(values)
    adv = torch.zeros_like(last_values)
    next_values = last_values
    for t in reversed(range(values.shape[0])):
        delta = rewards[t] + not_terminal[t] * gamma * next_values - values[t]
        adv = delta + not_terminal[t] * (gamma * lam) * adv
        advantages[t] = adv
        next_values = values[t]
    returns = advantages + values
    if normalize_advantage:
        advantages = whiten(advantages, eps=eps)
    return returns, advantages


def whiten(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``(x - mean) / (std + eps)`` over all elements, unbiased std."""
    return (x - x.mean()) / (x.std(unbiased=True) + eps)
