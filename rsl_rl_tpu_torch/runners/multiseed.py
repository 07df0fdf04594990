"""Multi-seed training: G independent runs as one batched program (counterpart
of ``rsl_rl_tpu/runners/multiseed.py``).

The JAX package gets a seed study from ``jax.vmap`` over its pure collect
and update functions. The port stacks the G seeds' training states on a
leading axis (``algorithms.ppo.StackedTrainState``) and runs the policy
through ``torch.func.vmap`` (PyTorch's model-ensembling idiom): one batched
call per policy step and per minibatch for all seeds, the env stepping all
``G * num_envs`` envs at once, and the recurrent replays taking the xproj
kernels with the seeds (and the actor and critic memories) as their stream
axis, as the JAX package's replays take its xproj cores under ``vmap``.
Seeds share no state: each has its own policy init, env draws, action noise,
normalizer moments, advantage normalization, learning rate, clip and
optimizer, and its own RND state. A distillation study stacks students
beside one shared teacher (``MultiSeedRunner.load_teacher``).
"""

from __future__ import annotations

from typing import Callable

from rsl_rl_tpu_torch.storage.rollout import tree_map
from rsl_rl_tpu_torch.utils.device import resolve_device


def make_multiseed_train(alg, env, num_steps_per_env: int, num_seeds: int,
                         device="cuda") -> tuple[Callable, Callable]:
    """Build ``(init, train_step)`` for multi-seed training.

    ``alg`` is a PPO or a Distillation whose policy serves as the
    architecture template; ``env`` has ``num_envs`` envs per seed.

    ``init(policies, seed) -> (ts, cs)`` stacks the ``num_seeds`` policies
    (each with its own init) into the training state, resets
    ``num_seeds * env.num_envs`` envs from ``seed`` and zeroes the carries;
    ``ts`` and ``cs`` carry a leading seed axis.

    ``train_step(ts, cs, action_noise=None) -> (ts, cs, metrics)`` runs one
    collect + update iteration for every seed; every metric gains a leading
    ``[num_seeds]`` axis. ``action_noise [G, T, E, A]`` replaces the normal
    draws of the action sampling.

    Runs on CUDA unless ``device="cpu"``; raises without CUDA otherwise.
    """
    device = resolve_device(device)
    if alg.device != device or env.device != device:
        raise ValueError(f"the algorithm lives on {alg.device} and the env on {env.device},"
                         f" the multi-seed program on {device}")
    G, E = int(num_seeds), env.num_envs

    def init(policies, seed: int):
        if len(policies) != G:
            raise ValueError(f"expected {G} policies, one per seed, got {len(policies)}")
        ts = alg.init_stacked_state(policies, E)
        env_state, obs = env.reset(seed, num_envs=G * E)
        obs = tree_map(lambda x: x.reshape(G, E, *x.shape[1:]), obs)
        return ts, alg.init_stacked_collect_state(env_state, obs, G)

    def train_step(ts, cs, action_noise=None):
        cs, rollout, cm = alg.collect_stacked(env, ts, cs, num_steps_per_env, action_noise)
        ts, cs, um = alg.update_stacked(ts, cs, rollout)
        return ts, cs, {**cm, **um}

    return init, train_step
