"""Multi-seed training runner (counterpart of
``rsl_rl_tpu/runners/multiseed_runner.py``): G independent seeds of one
config trained as one batched program, with the console line and trailing
per-seed reward windows of the JAX runner, the loop of
``runners/training_loop.py`` (split or whole-iteration dispatch; with a
``log_dir`` cross-seed scalars, periodic checkpoints, the git state and the
profiler window) and stacked checkpoints (``save`` / ``load`` /
``load_latest``).

``save_seed``, ``load_teacher``, evaluation and PBT are not ported yet.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

import rsl_rl_tpu_torch.algorithms  # noqa: F401  (registers the algorithms)
import rsl_rl_tpu_torch.modules  # noqa: F401  (registers the policies)
from rsl_rl_tpu_torch.modules.policy import check_state_compatible
from rsl_rl_tpu_torch.runners.multiseed import make_multiseed_train
from rsl_rl_tpu_torch.runners.on_policy_runner import check_unported_keys
from rsl_rl_tpu_torch.runners.training_loop import TrainingLoop
from rsl_rl_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import resolve
from rsl_rl_tpu_torch.utils.resolvers import resolve_obs_groups


def seed_sequence(seed: int, num_seeds: int) -> list[int]:
    """The policy-init seeds of a study, drawn from its ``seed``. (A policy
    seeds its memories with ``seed + 1``, so consecutive integers would give
    one seed's memories the stream of the next seed's MLPs.)"""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2**31 - 1, (num_seeds,), generator=gen).tolist()


class MultiSeedRunner(TrainingLoop):
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
        self.cfg = dict(train_cfg)
        check_unported_keys(self.cfg)
        self.alg_cfg = dict(train_cfg["algorithm"])
        for key in ("rnd_cfg", "symmetry_cfg"):
            if self.alg_cfg.get(key) is not None:
                raise NotImplementedError(f"{key} is not ported to multi-seed training yet (ROADMAP.md Queue 1"
                                          " item 5)")
        self.policy_cfg = dict(train_cfg["policy"])
        self.env = env
        self.num_seeds = int(num_seeds)
        self.num_steps_per_env = self.cfg["num_steps_per_env"]
        self._init_loop(log_dir)
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
        # the split iteration calls the collect and update halves of
        # make_multiseed_train's train_step itself, to time them apart; the
        # fused iteration is train_step
        init, self._train_step = make_multiseed_train(self.alg, env, self.num_steps_per_env, self.num_seeds,
                                                      self.device)
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
        self._prepare_logging_writer()
        start_iter = self.current_learning_iteration
        self._run(start_iter, start_iter + num_learning_iterations)

    def _split_iteration(self):
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
        return {k: v.detach().cpu().numpy() for k, v in {**cm, **um}.items()}, collection_time, learn_time

    # the fused iteration (training_loop.TrainingLoop): the train state and
    # the collect state are its state tree

    def _graph_state(self):
        return self.train_state, self.collect_state

    def _set_graph_state(self, state) -> None:
        self.train_state, self.collect_state = state

    def _graph_step(self, state):
        ts, cs, metrics = self._train_step(*state)
        return (ts, cs), metrics

    def _to_host(self, metrics: dict) -> dict:
        return metrics

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

    def _log(self, it: int, start_iter: int, tot_iter: int, metrics: dict, collection_time: float,
             learn_time: float) -> None:
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
        rew, length, ep_count = self._window_stats(metrics)
        if self.writer is not None:
            self._write_scalars(it, metrics, fps, rew, length, ep_count)
        print(f"[multiseed {self.num_seeds}x] it {it}: reward {rew.mean():.2f} +/- "
              f"{rew.std():.2f}  len {length.mean():.1f}  {fps} steps/s")

    def _write_scalars(self, it, metrics, fps, rew, length, ep_count) -> None:
        """Cross-seed means and spreads (the JAX package's ``_log``)."""
        w = self.writer
        for key, value in metrics.items():
            if key.startswith("Loss/"):
                w.add_scalar(key, float(np.mean(value)), it)
                w.add_scalar(f"{key}_std", float(np.std(value)), it)
        w.add_scalar("Policy/mean_noise_std", float(np.mean(metrics["Policy/mean_noise_std"])), it)
        w.add_scalar("Perf/total_fps", fps, it)
        if ep_count > 0:
            w.add_scalar("Train/mean_reward", float(rew.mean()), it)
            w.add_scalar("Train/mean_reward_std", float(rew.std()), it)
            w.add_scalar("Train/mean_episode_length", float(length.mean()), it)
            w.add_scalar("Train/mean_episode_length_std", float(length.std()), it)

    # ----------------------------------------------------------- checkpoints

    def save(self, path: str, infos=None) -> None:
        """One stacked checkpoint of the whole study (a leading seed axis on
        every tensor): the policies' parameters and normalizer moments, the
        Adam moments and counts, the learning rates, the iteration, the seed
        count and ``infos`` (plain data)."""
        ts = self.train_state
        save_checkpoint(path, {
            "model": {"params": ts.params, "buffers": ts.buffers},
            "opt_state": {"mu": ts.adam_mu, "nu": ts.adam_nu, "count": ts.adam_count},
            "lr": ts.lr,
            "iter": int(self.current_learning_iteration),
            "num_seeds": self.num_seeds,
            "infos": infos,
        })
        self._upload_model(path)

    def load(self, path: str):
        """Resume the whole study from a :meth:`save` checkpoint, bit for bit
        and in place; returns its ``infos``. A checkpoint of another seed
        count or other policies raises ``ValueError`` before anything is
        copied."""
        loaded = load_checkpoint(path, map_location=self.device)
        if int(loaded.get("num_seeds", -1)) != self.num_seeds:
            raise ValueError(f"Checkpoint {path!r} holds {loaded.get('num_seeds')} seeds; this runner is"
                             f" configured for {self.num_seeds}.")
        ts = self.train_state
        model, opt = loaded["model"], loaded["opt_state"]
        parts = [(ts.params, model["params"], "policy parameters"), (ts.buffers, model["buffers"], "policy buffers"),
                 (ts.adam_mu, opt["mu"], "optimizer mu"), (ts.adam_nu, opt["nu"], "optimizer nu"),
                 ({"count": ts.adam_count, "lr": ts.lr}, {"count": opt["count"], "lr": loaded["lr"]},
                  "optimizer count and learning rate")]
        for current, new, what in parts:
            check_state_compatible(current, new, what)
        with torch.no_grad():
            for current, new, _ in parts:
                for k, t in current.items():
                    t.copy_(new[k])
        self.current_learning_iteration = int(loaded["iter"])
        return loaded["infos"]

    def load_latest(self, log_dir: str | None = None) -> bool:
        """Resume from the newest ``model_<it>.pt`` in ``log_dir`` (this
        runner's by default); returns False when there is none."""
        path = latest_checkpoint(log_dir or self.log_dir or "")
        if path is None:
            return False
        self.load(path)
        return True
