"""Name-to-object resolvers for config-driven construction (counterpart of
``rsl_rl_tpu/utils/resolvers.py``): activations, optimizers, ``"module:attr"``
callables and observation sets."""

from __future__ import annotations

import importlib
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


# The optimizers' update directions, optax's formulas as the JAX package chains
# them. Each is pure (``torch.func.vmap`` runs it for G seeds):
# ``direction(grads, params, mu, nu, count) -> (updates, mu, nu, count)``,
# applied as ``p - lr * u``. ``mu`` is the first moment (adam, adamw), ``nu``
# the second (adam, adamw, rmsprop); an optimizer that keeps none leaves
# them as they are. ``count`` counts the steps.

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _adam(grads, params, mu, nu, count):
    """``optax.scale_by_adam`` (b1=0.9, b2=0.999, eps=1e-8, eps_root=0)."""
    count = count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(c, _B1), c)
    bc2 = 1.0 - torch.pow(torch.full_like(c, _B2), c)
    mu = [(1.0 - _B1) * g + _B1 * m for g, m in zip(grads, mu)]
    nu = [(1.0 - _B2) * (g * g) + _B2 * v for g, v in zip(grads, nu)]
    return [(m / bc1) / (torch.sqrt(v / bc2) + _EPS) for m, v in zip(mu, nu)], mu, nu, count


def _adamw(grads, params, mu, nu, count, weight_decay: float = 1e-2):
    """``scale_by_adam`` then ``add_decayed_weights(1e-2)`` (torch AdamW's
    default decay, decoupled: scaled by the learning rate with the rest)."""
    updates, mu, nu, count = _adam(grads, params, mu, nu, count)
    return [u + weight_decay * p for u, p in zip(updates, params)], mu, nu, count


def _sgd(grads, params, mu, nu, count):
    """``optax.identity``."""
    return list(grads), mu, nu, count + 1


def _rmsprop(grads, params, mu, nu, count, decay: float = 0.99, eps: float = 1e-8):
    """``optax.scale_by_rms(decay=0.99, eps=1e-8, eps_in_sqrt=False)``
    (torch RMSprop's alpha, eps outside the square root)."""
    nu = [(1.0 - decay) * (g * g) + decay * v for g, v in zip(grads, nu)]
    return [g * (1.0 / (torch.sqrt(v) + eps)) for g, v in zip(grads, nu)], mu, nu, count + 1


_OPTIMIZERS = {"adam": _adam, "adamw": _adamw, "sgd": _sgd, "rmsprop": _rmsprop}


def resolve_optimizer(optimizer_name: str) -> Callable:
    """The update direction of an optimizer by name (adam, adamw, sgd,
    rmsprop), without the learning rate: the algorithms apply ``p - lr * u``
    with their adaptive rate."""
    name = optimizer_name.lower()
    if name not in _OPTIMIZERS:
        raise ValueError(
            f"Invalid optimizer '{optimizer_name}'. Valid optimizers are: {list(_OPTIMIZERS)}"
        )
    return _OPTIMIZERS[name]


def string_to_callable(name: str) -> Callable:
    """Resolve a ``"module:attribute"`` string to a callable."""
    try:
        mod_name, attr_name = name.split(":")
        obj = getattr(importlib.import_module(mod_name), attr_name)
    except (AttributeError, ValueError) as err:
        raise ValueError(
            "We could not interpret the entry as a callable object. The format of input should be"
            f" 'module:attribute_name'\nWhile processing input '{name}', received the error:\n {err}."
        ) from err
    if not callable(obj):
        raise ValueError(f"The imported object is not callable: '{name}'")
    return obj


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
