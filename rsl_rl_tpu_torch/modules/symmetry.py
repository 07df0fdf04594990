"""Symmetry augmentation (counterpart of ``rsl_rl_tpu/modules/symmetry.py``).

The user's augmentation function has the reference's contract::

    data_augmentation_func(obs=None, actions=None, env=None) -> (obs_aug, actions_aug)

where ``obs`` / ``actions`` may each be ``None`` and the results stack
``num_aug`` symmetric copies along the leading batch axis, the original
first. A config may name it as ``"module:attr"`` (``utils/resolvers.py``
``string_to_callable``).
"""

from __future__ import annotations

import torch

from rsl_rl_tpu_torch.storage.rollout import tree_map


def resolve_symmetry_config(alg_cfg: dict, env) -> dict:
    """Give ``symmetry_cfg`` the env (``"_env"``), on a copy."""
    if alg_cfg.get("symmetry_cfg") is not None:
        alg_cfg["symmetry_cfg"] = {**alg_cfg["symmetry_cfg"], "_env": env}
    return alg_cfg


def _leading(obs, actions) -> int:
    return actions.shape[0] if actions is not None else next(iter(obs.values())).shape[0]


def apply_augmentation(aug_fn, env, obs, actions, time_major: bool):
    """Run the augmentation function over a minibatch; returns ``(obs_aug,
    actions_aug, num_aug)``.

    A feedforward batch ``[B, ...]`` goes straight through. A time-major
    batch ``[T, nb, ...]`` is flattened to ``[T*nb, ...]`` rows for the
    function and folded back to ``[T, num_aug*nb, ...]``, copy ``a`` in env
    columns ``[a*nb, (a+1)*nb)`` (copy 0 the original).
    """
    if not time_major:
        base = _leading(obs, actions)
        obs_a, act_a = aug_fn(obs=obs, actions=actions, env=env)
        return obs_a, act_a, _leading(obs_a, act_a) // base

    ref = actions if actions is not None else next(iter(obs.values()))
    T, nb = ref.shape[:2]
    obs_f = None if obs is None else {k: v.reshape(T * nb, *v.shape[2:]) for k, v in obs.items()}
    act_f = None if actions is None else actions.reshape(T * nb, *actions.shape[2:])
    obs_a, act_a = aug_fn(obs=obs_f, actions=act_f, env=env)
    num_aug = _leading(obs_a, act_a) // (T * nb)

    def fold(x):
        x = x.reshape(num_aug, T, nb, *x.shape[1:]).movedim(0, 1)
        return x.reshape(T, num_aug * nb, *x.shape[3:])

    obs_out = None if obs_a is None else {k: fold(v) for k, v in obs_a.items()}
    return obs_out, None if act_a is None else fold(act_a), num_aug


def tile_batch(x: torch.Tensor, num_aug: int, time_major: bool) -> torch.Tensor:
    """Repeat per-sample targets for each copy, in :func:`apply_augmentation`'s
    copy-major layout (batch axis 1 when time-major)."""
    lead = (1, num_aug) if time_major else (num_aug,)
    return x.repeat(*lead, *([1] * (x.ndim - len(lead))))


def tile_carry(carry, num_aug: int):
    """Repeat a recurrent carry (env axis 0) for each copy: every copy
    replays from the window-start carry of the original."""
    return tree_map(lambda h: h.repeat(num_aug, *([1] * (h.ndim - 1))), carry)
