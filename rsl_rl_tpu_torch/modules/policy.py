"""Observation-set helpers shared by the policy modules (counterpart of
``rsl_rl_tpu/modules/policy.py``).

The JAX package hoists a policy's state into a ``PolicyState`` pytree
(``params`` + normalizer ``norm``). In the port that state is the policy
``nn.Module`` itself: its parameters are the trainable ``params`` and its
``RunningNormState`` submodules hold the normalizer moments as buffers. G
seeds' states stack on a leading axis (``torch.func.stack_module_state``),
and :func:`seed_call` runs a policy method for all of them in one batched
call, as ``jax.vmap`` does in the JAX package.
"""

from __future__ import annotations

import torch
from torch.func import functional_call, vmap


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


def seed_call(policy, params: dict, buffers: dict, method: str, *args, out_dims=0):
    """``policy.<method>(*args)`` for each of G seeds in one batched call.

    ``params`` and ``buffers`` hold the G seeds' policy states stacked on a
    leading ``[G]`` axis by module name (``torch.func.stack_module_state``);
    every tensor in ``args`` carries the same leading axis. ``torch.func.vmap``
    runs ``policy`` with each seed's state substituted
    (``torch.func.functional_call``), so the batched call computes what G
    separate calls would: per-seed normalizer moments, per-seed carries. An
    in-place normalizer update writes into ``buffers``. A method that returns
    nothing takes ``out_dims=None``.
    """

    def one(p, b, *a):
        return functional_call(policy, (p, b), (method, *a))

    return vmap(one, out_dims=out_dims)(params, buffers, *args)


def check_state_compatible(current: dict, loaded: dict, what: str = "policy state") -> None:
    """Raise ``ValueError`` naming the missing and unexpected keys and the
    shape mismatches when a loaded state dict does not match ``current``
    (the JAX package's ``check_state_compatible``; checked before anything
    is copied, so a refused load changes nothing)."""
    missing = sorted(set(current) - set(loaded))
    unexpected = sorted(set(loaded) - set(current))
    mismatched = sorted(
        f"{k}: expected {tuple(current[k].shape)}, got {tuple(loaded[k].shape)}"
        for k in set(current) & set(loaded)
        if tuple(current[k].shape) != tuple(loaded[k].shape)
    )
    if missing or unexpected or mismatched:
        raise ValueError(
            f"Loaded {what} is incompatible with the current model configuration.\n"
            + (f"  missing keys: {missing[:8]}\n" if missing else "")
            + (f"  unexpected keys: {unexpected[:8]}\n" if unexpected else "")
            + (f"  shape mismatches: {mismatched[:8]}\n" if mismatched else "")
        )
