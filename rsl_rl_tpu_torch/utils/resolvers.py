"""Name-to-object resolvers for config-driven construction (the part of
``rsl_rl_tpu/utils/resolvers.py`` the on-policy runner needs)."""

from __future__ import annotations

import warnings
from typing import Any, Callable

import torch
import torch.nn.functional as F

_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "elu": F.elu,
    "selu": F.selu,
    "relu": F.relu,
    "crelu": F.celu,  # the reference maps "crelu" to torch.nn.CELU
    "lrelu": F.leaky_relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "gelu": F.gelu,
    "swish": F.silu,
    "mish": F.mish,
    "identity": lambda x: x,
}


def resolve_nn_activation(act_name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation function by name (the reference's twelve names)."""
    name = act_name.lower()
    if name not in _ACTIVATIONS:
        raise ValueError(
            f"Invalid activation function '{act_name}'. Valid activations are: {list(_ACTIVATIONS)}"
        )
    return _ACTIVATIONS[name]


def resolve_obs_groups(
    obs: dict[str, Any], obs_groups: dict[str, list[str]], default_sets: list[str]
) -> dict[str, list[str]]:
    """Validate the obs-set configuration and default missing sets.

    Same contract as the JAX package's ``resolve_obs_groups``: ``"policy"``
    must be configured (or an obs group named ``"policy"`` exists), empty or
    unknown groups are rejected, and each missing default set falls back to a
    like-named obs group or to a copy of the ``"policy"`` set, with warnings.
    """
    obs_groups = {k: list(v) for k, v in obs_groups.items()}

    if "policy" not in obs_groups:
        if "policy" not in obs:
            raise ValueError(
                "The observation configuration dictionary 'obs_groups' must contain the 'policy' key."
                f" Found keys: {list(obs_groups.keys())}"
            )
        obs_groups["policy"] = ["policy"]
        warnings.warn(
            "The observation configuration dictionary 'obs_groups' must contain the 'policy' key."
            " As an observation group with the name 'policy' was found, this is assumed to be the"
            " observation set."
        )

    for set_name, groups in obs_groups.items():
        if len(groups) == 0:
            raise ValueError(
                f"The '{set_name}' key in the 'obs_groups' dictionary can not be an empty list."
            )
        for group in groups:
            if group not in obs:
                raise ValueError(
                    f"Observation '{group}' in observation set '{set_name}' not found in the"
                    f" observations from the environment. Available: {list(obs.keys())}"
                )

    for default_set_name in default_sets:
        if default_set_name in obs_groups:
            continue
        if default_set_name in obs:
            obs_groups[default_set_name] = [default_set_name]
        else:
            obs_groups[default_set_name] = obs_groups["policy"].copy()
        warnings.warn(
            f"The observation configuration dictionary 'obs_groups' must contain the"
            f" '{default_set_name}' key; using {obs_groups[default_set_name]}."
        )

    print("-" * 80)
    print("Resolved observation sets: ")
    for set_name, groups in obs_groups.items():
        print("\t", set_name, ": ", groups)
    print("-" * 80)
    return obs_groups
