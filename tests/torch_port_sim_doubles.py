"""Torch doubles of an MJX simulator and a Brax env, the twins of the JAX
doubles of ``tests/test_torch_port_sim_adapters.py`` (and of
``tests/test_mjx_env.py``'s): damped point masses, one per degree of
freedom, with the same arithmetic in the same order. It imports no JAX.

``mjx`` has MJX's four functions on torch tensors (``MJXEnv(..., sim=mjx)``;
``examples/train_mjx_torch.py --sim tests.torch_port_sim_doubles:mjx``),
``BraxChain`` is a Brax-shaped single env for ``BraxVecEnv``.
"""

from __future__ import annotations

import dataclasses
import types
from dataclasses import dataclass, field

import torch

from rsl_rl_tpu_torch.env.nlink import hash_draws, uniform_draws


@dataclass
class Data:
    qpos: torch.Tensor
    qvel: torch.Tensor
    ctrl: torch.Tensor


def put_model(m, device=None):
    return types.SimpleNamespace(nq=m.nq, nv=m.nv, nu=m.nu, opt=m.opt, device=device)


def make_data(model) -> Data:
    return Data(qpos=torch.zeros(model.nq, device=model.device), qvel=torch.zeros(model.nv, device=model.device),
                ctrl=torch.zeros(model.nu, device=model.device))


def forward(model, data: Data) -> Data:
    return data


def step(model, data: Data) -> Data:
    dt = model.opt.timestep
    qvel = data.qvel + dt * (data.ctrl - 0.1 * data.qvel)
    return dataclasses.replace(data, qpos=data.qpos + dt * qvel, qvel=qvel)


mjx = types.SimpleNamespace(put_model=put_model, make_data=make_data, forward=forward, step=step)


def mj_model(nq=1, nv=1, nu=1, timestep=0.02):
    """A host model's fields as the adapter reads them."""
    return types.SimpleNamespace(nq=nq, nv=nv, nu=nu, opt=types.SimpleNamespace(timestep=timestep))


@dataclass
class BraxChainState:
    pipeline: dict  # {"x", "v"}: the nested sim state
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    metrics: dict = field(default_factory=dict)


class BraxChain:
    """Single-env double of ``brax.envs.Env``: ``size`` free point masses,
    Brax's dtypes (float 0/1 ``done``, a ``metrics`` dict), terminal when
    any ``|x|`` leaves ``bound``; a reset draws ``x`` uniform in
    ``[-reset_scale, reset_scale)`` from its key (nothing at scale 0)."""

    dt = 0.05

    def __init__(self, size: int = 1, bound: float = 0.5, reset_scale: float = 0.1):
        self.action_size = size
        self.bound, self.reset_scale = bound, reset_scale

    def _state(self, x, v, reward, done):
        return BraxChainState(pipeline={"x": x, "v": v}, obs=torch.cat([x, v]), reward=reward, done=done,
                              metrics={"max_abs_x": torch.abs(x).max()})

    def reset(self, key):
        zero = torch.zeros(self.action_size, device=key.device)
        if self.reset_scale:
            _, bits = hash_draws(key.reshape(1), self.action_size)
            x = uniform_draws(bits[0], -self.reset_scale, 2 * self.reset_scale)
        else:
            x = zero
        return self._state(x, zero, zero.sum(), zero.sum())

    def step(self, state, action):
        v = state.pipeline["v"] + self.dt * action
        x = state.pipeline["x"] + self.dt * v
        done = (torch.abs(x) > self.bound).any().to(torch.float32)
        return self._state(x, v, -torch.sum(x * x), done)
