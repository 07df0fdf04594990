"""Multi-seed training runner (counterpart of
``rsl_rl_tpu/runners/multiseed_runner.py``): G independent seeds of one
config trained as one batched program, with the console line and trailing
per-seed reward windows of the JAX runner.

Logging writers, checkpoints (``save``/``load``/``save_seed``), evaluation,
multi-iteration dispatch, ``load_teacher`` and PBT are not ported yet;
passing a ``log_dir`` raises.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

import rsl_rl_tpu_torch.algorithms  # noqa: F401  (registers the algorithms)
import rsl_rl_tpu_torch.modules  # noqa: F401  (registers the policies)
from rsl_rl_tpu_torch.runners.multiseed import make_multiseed_train
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import resolve
from rsl_rl_tpu_torch.utils.resolvers import resolve_obs_groups


def seed_sequence(seed: int, num_seeds: int) -> list[int]:
    """The policy-init seeds of a study, drawn from its ``seed``. (A policy
    seeds its memories with ``seed + 1``, so consecutive integers would give
    one seed's memories the stream of the next seed's MLPs.)"""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2**31 - 1, (num_seeds,), generator=gen).tolist()


class MultiSeedRunner:
    """Train ``num_seeds`` independent runs of ``train_cfg`` as one batched
    program on one device.

    The config schema is :class:`OnPolicyRunner`'s; ``cfg["seed"]`` seeds the
    whole study (each seed's policy init comes from :func:`seed_sequence`, the
    env draws from per-env keys in the env state derived from it, the action
    noise from one generator drawn for all seeds at once). ``env`` has ``num_envs`` envs per seed: the runner steps
    ``num_seeds * env.num_envs`` of them.
    """

    def __init__(self, env, train_cfg: dict, num_seeds: int, log_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"the env lives on {env.device}, the runner on {self.device}")
        if log_dir is not None:
            raise NotImplementedError(
                "logging writers and checkpoints are not ported yet (ROADMAP.md Queue 1,"
                " 'Runner and utils'); pass log_dir=None"
            )
        self.cfg = dict(train_cfg)
        self.alg_cfg = dict(train_cfg["algorithm"])
        self.policy_cfg = dict(train_cfg["policy"])
        self.env = env
        self.num_seeds = int(num_seeds)
        self.num_steps_per_env = self.cfg["num_steps_per_env"]
        seed = int(self.cfg.get("seed", 1))

        _, obs = env.reset(seed)  # probe the obs groups
        self.cfg["obs_groups"] = resolve_obs_groups(obs, self.cfg["obs_groups"], ["critic"])
        policy_class = resolve("policy", self.policy_cfg.pop("class_name"))
        policies = [
            policy_class(obs, self.cfg["obs_groups"], env.num_actions, device=self.device, seed=s,
                         **self.policy_cfg)
            for s in seed_sequence(seed, self.num_seeds)
        ]
        alg_class = resolve("algorithm", self.alg_cfg.pop("class_name"))
        self.alg = alg_class(policies[0], seed=seed + 1, **self.alg_cfg)
        # learn() calls the collect and update halves of make_multiseed_train's
        # train_step itself, to time them apart
        init, _ = make_multiseed_train(self.alg, env, self.num_steps_per_env, self.num_seeds, self.device)
        self.train_state, self.collect_state = init(policies, seed)

        self.tot_timesteps = 0
        self.tot_time = 0.0
        self.current_learning_iteration = 0
        #: one dict per finished iteration: collection_s, learn_s, steps_per_s,
        #: metrics (numpy ``[num_seeds]`` each)
        self.history: list[dict] = []
        self._ep_window: deque = deque()  # per-seed (rew_sum, len_sum, count) per iteration

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def learn(self, num_learning_iterations: int) -> None:
        start_iter = self.current_learning_iteration
        for it in range(start_iter, start_iter + num_learning_iterations):
            start = time.perf_counter()
            cs, rollout, cm = self.alg.collect_stacked(self.env, self.train_state, self.collect_state,
                                                       self.num_steps_per_env)
            self._sync()
            collection_time = time.perf_counter() - start

            start = time.perf_counter()
            _, cs, um = self.alg.update_stacked(self.train_state, cs, rollout)
            self._sync()
            learn_time = time.perf_counter() - start

            self.collect_state = cs
            self.current_learning_iteration = it
            metrics = {k: v.detach().cpu().numpy() for k, v in {**cm, **um}.items()}
            self._log(it, metrics, collection_time, learn_time)

    def _window_stats(self, m: dict) -> tuple[np.ndarray, np.ndarray, float]:
        """Per-seed trailing ~100-episode reward and length means."""
        self._ep_window.append((m["ep_reward_sum"], m["ep_length_sum"], m["ep_count"]))
        while (len(self._ep_window) > 1
               and float(sum(e[2].sum() for e in self._ep_window) - self._ep_window[0][2].sum())
               >= 100.0 * self.num_seeds):
            self._ep_window.popleft()
        count, rew, length = self._window_reduce()
        return rew, length, float(count.sum())

    def _window_reduce(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-seed episode ``(count, mean reward, mean length)`` of the
        current window, the one definition logging and :meth:`seed_rewards` use."""
        count = sum(e[2] for e in self._ep_window)
        safe = np.maximum(count, 1.0)
        return count, sum(e[0] for e in self._ep_window) / safe, sum(e[1] for e in self._ep_window) / safe

    def seed_rewards(self) -> tuple[np.ndarray, float]:
        """Per-seed trailing-window mean rewards and the window's total count
        of finished episodes (read-only; a count of 0 means no episode has
        finished and the rewards say nothing)."""
        if not self._ep_window:
            return np.zeros(self.num_seeds), 0.0
        count, rew, _ = self._window_reduce()
        return np.asarray(rew), float(np.asarray(count).sum())

    def _log(self, it: int, metrics: dict, collection_time: float, learn_time: float) -> None:
        iteration_time = collection_time + learn_time
        collection_size = self.num_steps_per_env * self.env.num_envs * self.num_seeds
        self.tot_timesteps += collection_size
        self.tot_time += iteration_time
        fps = int(collection_size / iteration_time)
        self.history.append({
            "iteration": it,
            "collection_s": collection_time,
            "learn_s": learn_time,
            "steps_per_s": collection_size / iteration_time,
            "metrics": metrics,
        })
        rew, length, _ = self._window_stats(metrics)
        print(f"[multiseed {self.num_seeds}x] it {it}: reward {rew.mean():.2f} +/- "
              f"{rew.std():.2f}  len {length.mean():.1f}  {fps} steps/s")
