"""Brax-shaped environment adapter (counterpart of ``rsl_rl_tpu/env/brax_env.py``).

Brax envs are pure state machines of one env, so this wrapper is thin: it
maps a single-env environment over ``num_envs`` with ``torch.func.vmap``,
adds time-limit truncation with ``extras["time_outs"]`` and per-env
auto-reset, exposes the obs as the ``"policy"`` group and the env's
``metrics`` as ``extras["log"]``.

Brax itself is a JAX library and the port imports no JAX, so there is no
import gate here: the env object is passed in, a Brax-shaped env on torch
tensors with

- ``reset(key)``: ``key`` a 0-d int64 tensor, one env's key, from which the
  env draws with ``env/nlink.py``'s ``hash_draws`` / ``uniform_draws`` (of
  ``key.reshape(1)``), as a Brax env draws from its PRNG key;
- ``step(state, action)``;
- both returning a dataclass with ``obs``, ``reward``, ``done`` and
  ``metrics`` (a dict) among its fields, any other fields (the pipeline
  state) a tree of dataclasses, dicts and lists of tensors;
- ``action_size`` and optionally ``dt``.

Usage::

    env = BraxVecEnv(MyTorchAnt(), num_envs=4096, episode_length=1000)
    runner = OnPolicyRunner(env, train_cfg, log_dir)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from rsl_rl_tpu_torch.env.nlink import env_keys, hash_draws, random_episode_lengths
from rsl_rl_tpu_torch.env.vec_env import (
    EnvState,
    VecEnv,
    as_episode_length,
    check_episode_length,
    vmap_tree,
    where_tree,
)
from rsl_rl_tpu_torch.utils.cuda_graph import flatten
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import register


@dataclass
class BraxState(EnvState):
    rng: torch.Tensor  # [N] int64 per-env keys of the reset draws
    brax: Any  # the env's batched state (leading axis N)


@register("env")
class BraxVecEnv(VecEnv):
    """Vectorized Brax-shaped environment with auto-reset and timeout extras."""

    def __init__(self, brax_env, num_envs: int, episode_length: int, cfg: dict | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.brax_env = brax_env
        self.num_envs = num_envs
        self.max_episode_length = as_episode_length(episode_length, self.device)
        self.num_actions = brax_env.action_size
        self.cfg = cfg or {}
        self.step_dt = float(getattr(brax_env, "dt", 0.0)) or None

    def _reset_envs(self, rng: torch.Tensor) -> tuple[torch.Tensor, Any]:
        """Each env's next key and the env's ``reset`` of a fresh key, one
        64-bit draw of each env's key."""
        rng, bits = hash_draws(rng, 1)
        return rng, vmap_tree(self.brax_env.reset, bits[:, 0])

    def _obs(self, state: BraxState) -> dict[str, torch.Tensor]:
        return {"policy": state.brax.obs}

    def reset(self, seed: int = 0, num_envs: int | None = None, env_offset: int = 0):
        num_envs = self.num_envs if num_envs is None else int(num_envs)
        check_episode_length(self.max_episode_length, num_envs)
        rng, brax_state = self._reset_envs(env_keys(seed, num_envs, self.device, env_offset))
        leaves, build = flatten(brax_state)
        state = BraxState(
            episode_length=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            rng=rng,
            brax=build([t.clone() for t in leaves]),  # own storage for every field
        )
        return state, self._obs(state)

    def randomize_episode_length(self, state: BraxState) -> BraxState:
        """Scatter the episode lengths over ``[0, max_episode_length_i)``
        (``init_at_random_ep_len``), drawn from each env's key, which advances."""
        return random_episode_lengths(state, self.max_episode_length)

    def step(self, state: BraxState, actions: torch.Tensor):
        brax_state = vmap_tree(self.brax_env.step, state.brax, actions)
        rew = brax_state.reward.to(torch.float32)
        terminal = brax_state.done.to(torch.bool)

        episode_length = state.episode_length + 1
        time_out = episode_length >= self.max_episode_length
        done = terminal | time_out

        # auto-reset done envs from fresh per-env keys; leaves that are not
        # tensors pass through
        rng, fresh = self._reset_envs(state.rng)
        brax_state = where_tree(done, fresh, brax_state)

        state = BraxState(
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            rng=rng,
            brax=brax_state,
        )
        extras = {
            "time_outs": time_out & ~terminal,
            "log": dict(brax_state.metrics) if brax_state.metrics else {},
        }
        return state, self._obs(state), rew, done, extras
