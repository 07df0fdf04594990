"""Deterministic policy evaluation (counterpart of
``rsl_rl_tpu/utils/evaluation.py``).

A rollout of a fresh copy of the env (the training env state is not
touched: the env is a function of its state) with the policy's
deterministic action (``act_inference``), carry resets of done envs, and the
completed episodes reduced on the device, with one host read at the end
(:func:`evaluate_policy`). The program is a function of the policy's
parameters and buffers, so a study evaluates every seed in one batched
rollout: the seeds' stacked states run through ``torch.func.vmap``
(``modules.policy.seed_call``), each seed on its own envs.

Used by the runners when ``eval_interval`` is set (``Eval/*`` scalars).
"""

from __future__ import annotations

from functools import partial

import torch
from torch.func import vmap

from rsl_rl_tpu_torch.algorithms.ppo import module_call
from rsl_rl_tpu_torch.modules.policy import seed_call
from rsl_rl_tpu_torch.storage.rollout import tree_map

EVAL_KEYS = ("Eval/episode_count", "Eval/mean_reward", "Eval/mean_episode_length", "Eval/min_return",
             "Eval/max_return")

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer on a Python int."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
    return z ^ (z >> 31)


def eval_seed(seed: int, it: int) -> int:
    """The env seed of the evaluation at iteration ``it`` of a run seeded
    with ``seed``: a stream apart from training's (the JAX package's
    ``fold_in(fold_in(key, 0xEA1), it)``), in ``[0, 2**62)``."""
    return _mix64(_mix64((int(seed) * 0x9E3779B97F4A7C15 + 0xEA1) & _MASK64) + int(it)) >> 2


def make_eval_program(env, policy, num_steps: int, random_actions: bool = False, num_seeds: int | None = None):
    """Build ``program(state, seed) -> metrics`` for deterministic evaluation.

    ``state`` is the policy's ``(params, buffers)`` by module name (None: the
    policy's own tensors); with ``num_seeds`` G, the seeds' stacked states
    (``[G, ...]`` each, a study's ``StackedTrainState.params`` and
    ``.buffers``), evaluated on ``G * env.num_envs`` envs at once. The
    program resets a fresh copy of ``env`` from ``seed``, rolls
    ``num_steps`` with ``act_inference`` (or standard-normal random actions,
    drawn from a generator seeded with ``seed``, for a baseline) and
    reduces the completed episodes on the device. Returns a dict of tensors
    (scalars, or ``[G]``):

    - ``Eval/episode_count``: completed episodes within the budget,
    - ``Eval/mean_reward`` / ``Eval/mean_episode_length``: means over the
      completed episodes (0 when none completed),
    - ``Eval/min_return`` / ``Eval/max_return``: extremes over completed
      episodes (``+-inf`` when none completed).
    """
    E, A = env.num_envs, env.num_actions
    lead = () if num_seeds is None else (int(num_seeds),)

    @torch.no_grad()
    def program(state, seed: int) -> dict[str, torch.Tensor]:
        device = policy.device
        n = E * (num_seeds or 1)
        env_state, obs = env.reset(seed, num_envs=n)
        obs = tree_map(lambda x: x.reshape(*lead, E, *x.shape[1:]), obs)
        carry = policy.initial_carry(E)
        if num_seeds is None:
            call = partial(module_call, policy, state)
            reset_carry = policy.reset_carry
        else:
            call = partial(seed_call, policy, *state)
            reset_carry = vmap(policy.reset_carry)
            carry = tree_map(lambda t: t.expand(num_seeds, *t.shape).clone(), carry)
        gen = torch.Generator(device=device).manual_seed(int(seed)) if random_actions else None
        cum = torch.zeros(*lead, E, device=device)
        length = torch.zeros(*lead, E, device=device)
        r_sum, r_cnt, l_sum = (torch.zeros(lead, device=device) for _ in range(3))
        r_min = torch.full(lead, float("inf"), device=device)
        r_max = torch.full(lead, float("-inf"), device=device)
        for _ in range(num_steps):
            if random_actions:
                action = torch.randn(*lead, E, A, generator=gen, device=device)
            else:
                action, carry = call("act_inference", obs, carry)
            env_state, *out = env.step(env_state, action.reshape(n, -1))
            obs, rew, done, _ = tree_map(lambda x: x.reshape(*lead, E, *x.shape[1:]), out)
            cum = cum + rew
            length = length + 1.0
            done_f = done.to(torch.float32)
            r_sum = r_sum + torch.sum(cum * done_f, dim=-1)
            r_cnt = r_cnt + torch.sum(done_f, dim=-1)
            l_sum = l_sum + torch.sum(length * done_f, dim=-1)
            r_min = torch.minimum(r_min, torch.where(done, cum, float("inf")).amin(dim=-1))
            r_max = torch.maximum(r_max, torch.where(done, cum, float("-inf")).amax(dim=-1))
            keep = 1.0 - done_f
            cum = cum * keep
            length = length * keep
            carry = reset_carry(carry, done)
        safe = torch.clamp(r_cnt, min=1.0)
        return dict(zip(EVAL_KEYS, (r_cnt, r_sum / safe, l_sum / safe, r_min, r_max)))

    return program


def evaluate_policy(env, policy, state, num_steps: int, seed: int, random_actions: bool = False,
                    num_seeds: int | None = None) -> dict:
    """Run :func:`make_eval_program` once and read its metrics to the host in
    one transfer: floats, or numpy ``[G]`` arrays with ``num_seeds``."""
    metrics = make_eval_program(env, policy, num_steps, random_actions, num_seeds)(state, seed)
    host = torch.stack([metrics[k] for k in EVAL_KEYS]).cpu().numpy()
    return {k: (host[i] if num_seeds is not None else float(host[i])) for i, k in enumerate(EVAL_KEYS)}
