"""Vectorized environment contract (counterpart of ``rsl_rl_tpu/env/vec_env.py``).

The env is a state machine over tensors that live on one device:

- ``reset(seed, num_envs=None) -> (state, obs)``
- ``step(state, actions) -> (state, obs, rewards, dones, extras)``

``reset`` initializes ``num_envs`` envs (the env's own ``num_envs`` by
default) and ``step`` steps as many as the state holds, so multi-seed
training steps the envs of all G seeds, ``G * num_envs``, in one call.

Observations are a dict of named groups; ``extras["time_outs"]`` marks
time-limit truncations (value bootstrap) and ``extras["log"]`` carries per-env
scalars. Environments auto-reset: where ``dones[i]`` is set, the returned obs
of env ``i`` is the first observation of a fresh episode. The random draws of
those resets come from per-env keys carried in the state (derived from
``reset``'s seed), so ``step`` is a function of its arguments; they differ
from the JAX package's threefry draws for the same seed.
"""

from __future__ import annotations

import abc
import copy
from dataclasses import dataclass
from typing import Any, Callable

import torch

from rsl_rl_tpu_torch.utils.cuda_graph import flatten


@dataclass
class EnvState:
    """Base env state: every field carries a leading ``num_envs`` axis.

    Attributes:
        episode_length: Current episode step counts, ``[num_envs]`` int32.
    """

    episode_length: torch.Tensor


def as_episode_length(value, device: torch.device | str = "cpu") -> int | torch.Tensor:
    """Normalize a ``max_episode_length`` config value: ints stay ints, any
    sequence becomes a per-env ``[num_envs]`` int32 tensor."""
    if isinstance(value, int):
        return value
    return torch.as_tensor(value, dtype=torch.int32, device=device)


def check_episode_length(value, num_envs: int, num_global: int | None = None) -> None:
    """A per-env ``max_episode_length`` must cover every env of the state
    (or, with ``num_global``, every env of the global count it is cut from)."""
    if isinstance(value, torch.Tensor) and value.numel() not in (num_envs, num_global):
        whole = "" if num_global in (None, num_envs) else f" (nor for the global {num_global})"
        raise ValueError(f"max_episode_length has {value.numel()} entries for {num_envs} envs{whole}")


def vmap_tree(fn: Callable, *trees) -> Any:
    """``fn`` of one env mapped over the leading env axis of ``trees`` with
    ``torch.func.vmap``, where each tree is a tensor or a tree of
    dataclasses, dicts, tuples and lists of tensors (a simulator's ``Data``,
    which is no torch pytree): the trees go in as their tensors and are
    rebuilt, one env's, inside ``fn``, whose result comes back the same way.
    Leaves of the result that are not tensors pass through; a tensor of the
    result that does not depend on the inputs comes back expanded over the
    envs (a view)."""
    flat = [flatten(t) for t in trees]
    out_build = []

    def one(*leaf_lists):
        leaves, build = flatten(fn(*(b(list(ls)) for (_, b), ls in zip(flat, leaf_lists))))
        out_build.append(build)
        return leaves

    leaves = torch.func.vmap(one)(*(ls for ls, _ in flat))
    return out_build[0](list(leaves))


def where_tree(done: torch.Tensor, fresh, tree) -> Any:
    """``tree`` with each tensor leaf replaced by ``fresh``'s where ``done``
    ``[N]`` is set (an auto-reset): both trees of one structure, every tensor
    leaf with the leading env axis."""
    leaves, build = flatten(tree)
    fresh_leaves, _ = flatten(fresh)
    if len(fresh_leaves) != len(leaves):
        raise ValueError(f"a fresh state of {len(fresh_leaves)} tensors for a state of {len(leaves)}")
    return build([torch.where(done.reshape((-1,) + (1,) * (t.ndim - 1)), f, t)
                  for f, t in zip(fresh_leaves, leaves)])


class VecEnv(abc.ABC):
    """Abstract vectorized environment on one torch device."""

    num_envs: int
    num_actions: int
    max_episode_length: int | torch.Tensor
    device: torch.device

    @abc.abstractmethod
    def reset(self, seed: int, num_envs: int | None = None,
              env_offset: int = 0) -> tuple[EnvState, dict[str, torch.Tensor]]:
        """Initialize ``num_envs`` envs (default ``self.num_envs``), their
        random keys derived from ``seed`` and their global index from
        ``env_offset`` on (a data-parallel rank resets its shard)."""

    def shard(self, env_offset: int, num_envs: int) -> "VecEnv":
        """The env that resets and steps the envs ``env_offset ..
        env_offset + num_envs`` of this one (a data rank's shard): itself,
        unless ``max_episode_length`` is per env over this env's
        ``num_envs``, which the shard's copy (shallow) holds as its slice. A
        per-env limit of neither count raises ``ValueError``."""
        limit = self.max_episode_length
        check_episode_length(limit, num_envs, self.num_envs)
        if not isinstance(limit, torch.Tensor) or limit.numel() == num_envs:
            return self
        part = copy.copy(self)
        part.max_episode_length = limit[env_offset:env_offset + num_envs]
        return part

    @abc.abstractmethod
    def step(
        self, state: EnvState, actions: torch.Tensor
    ) -> tuple[EnvState, dict[str, torch.Tensor], torch.Tensor, torch.Tensor, dict]:
        """Step the N envs of ``state``: ``(state, obs, rewards [N], dones [N] bool, extras)``."""
