"""Observation-set helpers shared by the policy modules (counterpart of
``rsl_rl_tpu/modules/policy.py``).

The JAX package hoists a policy's state into a ``PolicyState`` pytree
(``params`` + normalizer ``norm``). In the port that state is the policy
``nn.Module`` itself: its parameters are the trainable ``params`` and its
``RunningNormState`` submodules hold the normalizer moments as buffers.
"""

from __future__ import annotations

import torch


def concat_obs(obs: dict[str, torch.Tensor], groups: list[str]) -> torch.Tensor:
    """Concatenate the observation groups of one obs set along the last axis."""
    if len(groups) == 1:
        return obs[groups[0]]
    return torch.cat([obs[g] for g in groups], dim=-1)


def obs_set_dim(obs: dict[str, torch.Tensor], groups: list[str]) -> int:
    """Total feature width of an obs set; validates 1D observations per env."""
    dim = 0
    for g in groups:
        if obs[g].ndim != 2:
            raise ValueError("Policy modules only support 1D observations per env.")
        dim += obs[g].shape[-1]
    return dim
