"""MJX-shaped simulator adapter (counterpart of ``rsl_rl_tpu/env/mjx_env.py``).

Wraps a batched physics simulator with MuJoCo-MJX's functional interface as
a :class:`~rsl_rl_tpu_torch.env.VecEnv`: physics steps, observations,
rewards, terminals and auto-resets are torch ops on the card, so the whole
iteration stays on the device (and can be captured as a CUDA graph).

MJX itself is a JAX library and the port imports no JAX, so the simulator is
passed in: ``sim`` is a module (or any object) with MJX's four functions on
torch tensors,

- ``put_model(mj_model, device=...)`` -> the model the other three take;
- ``make_data(model)`` -> one env's ``Data``, a dataclass of tensors;
- ``forward(model, data)`` and ``step(model, data)`` -> one env's ``Data``.

The adapter maps them over the envs with ``torch.func.vmap``, as the JAX
adapter maps MJX with ``jax.vmap``; the user's callables are those of the
JAX adapter, for one env each, on torch tensors::

    env = MJXEnv(
        mj_model, num_envs=4096, episode_length=1000,
        obs_fn=lambda mx, d: {"policy": torch.cat([d.qpos, d.qvel])},
        reward_fn=lambda mx, d, action: d.qvel[0],        # forward speed
        done_fn=lambda mx, d: d.qpos[2] < 0.3,            # fallen over
        sim=my_torch_mjx,
    )
    runner = OnPolicyRunner(env, train_cfg, log_dir)

Every op those callables and the simulator run must have a ``vmap`` rule.
The reset draws come from per-env keys in the state (``env/nlink.py``
``hash_draws``), not from JAX's threefry, so they differ from the JAX
adapter's for the same seed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from rsl_rl_tpu_torch.env.nlink import env_keys, hash_draws, random_episode_lengths, uniform_draws
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
class MJXState(EnvState):
    rng: torch.Tensor  # [N] int64 per-env keys of the reset draws
    data: Any  # the simulator's batched Data (leading axis N)


@register("env")
class MJXEnv(VecEnv):
    """Vectorized environment over an MJX-shaped simulator on torch tensors.

    Args:
        mj_model: The host model (``mujoco.MjModel`` or anything with ``nq``,
            ``nv``, ``nu`` and ``opt.timestep``), put on the device by
            ``sim.put_model``.
        num_envs: Number of parallel environments.
        episode_length: Time-limit truncation horizon.
        obs_fn: ``(model, data) -> dict[str, [D] tensor]`` for ONE env
            (vmapped). Must return the same group names every call.
        reward_fn: ``(model, data, action) -> scalar`` for one env.
        done_fn: Optional ``(model, data) -> bool`` terminal predicate for
            one env (time-limit truncation is separate and reported in
            ``extras["time_outs"]``).
        reset_noise_scale: Uniform noise in ``[-scale, scale)`` added to the
            initial ``qpos`` / ``qvel`` of ``make_data`` on (auto-)reset.
        action_scale: Actions are multiplied by this before being applied as
            ``data.ctrl``.
        cfg: Arbitrary user config carried for API parity.
        sim: The MJX-shaped simulator (see the module docstring). Required:
            no torch package provides MJX's functions.
        device: ``"cuda"`` (default) or ``"cpu"``.
    """

    def __init__(
        self,
        mj_model,
        num_envs: int,
        episode_length: int,
        obs_fn: Callable,
        reward_fn: Callable,
        done_fn: Callable | None = None,
        reset_noise_scale: float = 0.01,
        action_scale: float = 1.0,
        cfg: dict | None = None,
        sim=None,
        device: str | torch.device = "cuda",
    ):
        if sim is None:
            raise ImportError(
                "MJXEnv needs an MJX-shaped simulator on torch tensors: MJX is a JAX library and no torch"
                " package provides its functions. Pass sim=, an object with put_model, make_data, forward"
                " and step on torch tensors."
            )
        self.device = resolve_device(device)
        self.sim = sim
        self.num_envs = num_envs
        self.max_episode_length = as_episode_length(episode_length, self.device)
        self.cfg = cfg or {}
        self.model = sim.put_model(mj_model, device=self.device)
        self.num_actions = int(mj_model.nu)
        self.obs_fn = obs_fn
        self.reward_fn = reward_fn
        self.done_fn = done_fn
        self.reset_noise_scale = float(reset_noise_scale)
        self.action_scale = action_scale
        self.step_dt = float(mj_model.opt.timestep)
        self._data0 = sim.make_data(self.model)
        self._nq, self._nv = self._data0.qpos.shape[0], self._data0.qvel.shape[0]

    # ------------------------------------------------------------- internals

    def _fresh(self, rng: torch.Tensor) -> tuple[torch.Tensor, Any]:
        """Each env's next key and a fresh batched ``Data``: ``make_data``'s
        state with ``nq + nv`` uniform perturbations in ``[-scale, scale)``
        drawn from each env's key, through ``forward``."""
        n, nq, s = rng.shape[0], self._nq, self.reset_noise_scale
        rng, bits = hash_draws(rng, nq + self._nv)
        noise = uniform_draws(bits, -s, 2 * s)
        leaves, build = flatten(self._data0)
        data = build([t.expand(n, *t.shape) for t in leaves])
        data = dataclasses.replace(data, qpos=data.qpos + noise[:, :nq], qvel=data.qvel + noise[:, nq:])
        return rng, vmap_tree(lambda d: self.sim.forward(self.model, d), data)

    def _obs(self, state: MJXState) -> dict[str, torch.Tensor]:
        return vmap_tree(lambda d: self.obs_fn(self.model, d), state.data)

    # -------------------------------------------------------------- contract

    def reset(self, seed: int = 0, num_envs: int | None = None, env_offset: int = 0):
        num_envs = self.num_envs if num_envs is None else int(num_envs)
        check_episode_length(self.max_episode_length, num_envs)
        # the advanced keys are carried, so the first auto-reset's draws are
        # not the initial ones (the JAX adapter reserves keys[0] for these)
        rng, data = self._fresh(env_keys(seed, num_envs, self.device, env_offset))
        leaves, build = flatten(data)
        state = MJXState(
            episode_length=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            rng=rng,
            data=build([t.clone() for t in leaves]),  # own storage for every field
        )
        return state, self._obs(state)

    def randomize_episode_length(self, state: MJXState) -> MJXState:
        """Scatter the episode lengths over ``[0, max_episode_length_i)``
        (``init_at_random_ep_len``), drawn from each env's key, which advances."""
        return random_episode_lengths(state, self.max_episode_length)

    def step(self, state: MJXState, actions: torch.Tensor):
        data = dataclasses.replace(state.data, ctrl=actions * self.action_scale)
        data = vmap_tree(lambda d: self.sim.step(self.model, d), data)
        rew = vmap_tree(lambda d, a: self.reward_fn(self.model, d, a), data, actions).to(torch.float32)

        episode_length = state.episode_length + 1
        time_out = episode_length >= self.max_episode_length
        if self.done_fn is not None:
            terminal = vmap_tree(lambda d: self.done_fn(self.model, d), data).to(torch.bool)
        else:
            terminal = torch.zeros_like(time_out)
        done = terminal | time_out

        # every env draws fresh data each step, kept where it is done (no
        # host sync on whether any env is done; every shape static)
        rng, fresh = self._fresh(state.rng)
        state = MJXState(
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            rng=rng,
            data=where_tree(done, fresh, data),
        )
        extras = {"time_outs": time_out & ~terminal}
        return state, self._obs(state), rew, done, extras
