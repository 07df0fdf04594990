"""Multi-seed training runner (counterpart of
``rsl_rl_tpu/runners/multiseed_runner.py``): G independent seeds of one
config trained as one batched program, with the console line and trailing
per-seed reward windows of the JAX runner, the loop of
``runners/training_loop.py`` (split or whole-iteration dispatch; with a
``log_dir`` cross-seed scalars, periodic checkpoints, the vmapped
deterministic evaluation, the git state and the profiler window) and stacked
checkpoints (``save`` / ``load`` / ``load_latest``). PPO (with RND and
symmetry) and distillation studies; ``load_teacher`` gives every seed of a
distillation study one teacher, ``save_seed`` exports one seed as a
single-seed checkpoint, and ``pbt=`` turns the study into population-based
training (``runners/pbt.py``).
"""

from __future__ import annotations

import copy
import time
from collections import deque

import numpy as np
import torch

import rsl_rl_tpu_torch.algorithms  # noqa: F401  (registers the algorithms)
import rsl_rl_tpu_torch.modules  # noqa: F401  (registers the policies)
from rsl_rl_tpu_torch.modules.policy import check_state_compatible
from rsl_rl_tpu_torch.modules.rnd import resolve_rnd_config
from rsl_rl_tpu_torch.modules.symmetry import resolve_symmetry_config
from rsl_rl_tpu_torch.runners.multiseed import make_multiseed_train
from rsl_rl_tpu_torch.runners.pbt import init_pbt_state, make_pbt_step
from rsl_rl_tpu_torch.runners.training_loop import TrainingLoop
from rsl_rl_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.evaluation import eval_seed, evaluate_policy
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

    The config schema is :class:`OnPolicyRunner`'s, with a PPO (RND and
    symmetry included) or a ``Distillation`` algorithm; ``cfg["seed"]`` seeds the
    whole study (each seed's policy init comes from :func:`seed_sequence`, the
    env draws from per-env keys in the env state derived from it, the action
    noise from one generator drawn for all seeds at once). ``env`` has ``num_envs`` envs per seed: the runner steps
    ``num_seeds * env.num_envs`` of them.
    """

    def __init__(self, env, train_cfg: dict, num_seeds: int, log_dir: str | None = None,
                 device: str | torch.device = "cuda", pbt: dict | None = None):
        if not getattr(env, "is_jax", True):
            raise ValueError("MultiSeedRunner requires a functional (device) env: host envs step on the host"
                             " and cannot be vmapped over the seed axis.")
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"the env lives on {env.device}, the runner on {self.device}")
        self.cfg = dict(train_cfg)
        self.alg_cfg = dict(train_cfg["algorithm"])
        self.policy_cfg = dict(train_cfg["policy"])
        self.env = env
        self.num_seeds = int(num_seeds)
        self.num_steps_per_env = self.cfg["num_steps_per_env"]
        self._init_loop(log_dir)
        seed = self.seed = int(self.cfg.get("seed", 1))

        _, obs = env.reset(seed)  # probe the obs groups
        default_sets = ["critic"]
        if self.alg_cfg.get("rnd_cfg") is not None:
            default_sets.append("rnd_state")
        self.cfg["obs_groups"] = resolve_obs_groups(obs, self.cfg["obs_groups"], default_sets)
        # the single-seed runner's config resolution: rnd_cfg gets its sizes
        # and step_dt scaling, symmetry_cfg the env
        self.alg_cfg = resolve_rnd_config(self.alg_cfg, obs, self.cfg["obs_groups"], env)
        self.alg_cfg = resolve_symmetry_config(self.alg_cfg, env)
        policy_class = resolve("policy", self.policy_cfg.pop("class_name"))
        policies = [
            policy_class(obs, self.cfg["obs_groups"], env.num_actions, device=self.device, seed=s,
                         **self.policy_cfg)
            for s in seed_sequence(seed, self.num_seeds)
        ]
        alg_class = resolve("algorithm", self.alg_cfg.pop("class_name"))
        self.alg = alg_class(policies[0], seed=seed + 1, **self.alg_cfg)
        # the split iteration calls the collect and update halves of
        # make_multiseed_train's train_step (and the PBT step) itself, to time
        # them apart; the fused iteration is the whole train step
        init, self._train_step = make_multiseed_train(self.alg, env, self.num_steps_per_env, self.num_seeds,
                                                      self.device)
        self.train_state, self.collect_state = init(policies, seed)
        self.pbt_cfg = None if pbt is None else dict(pbt)
        self.pbt_state = None
        if self.pbt_cfg is not None:
            self._pbt_step = make_pbt_step(self.num_seeds, **self.pbt_cfg)
            self.pbt_state = init_pbt_state(self.num_seeds, seed, self.device)

        self.tot_timesteps = 0
        self.tot_time = 0.0
        self.current_learning_iteration = 0
        #: one dict per finished iteration: collection_s, learn_s, steps_per_s,
        #: metrics (numpy ``[num_seeds]`` each, ``PBT/exploits`` a scalar)
        self.history: list[dict] = []
        self._ep_window: deque = deque()  # per-seed (rew_sum, len_sum, count) per iteration

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def learn(self, num_learning_iterations: int) -> None:
        if getattr(self.alg.policy, "loaded_teacher", True) is False:
            # every seed would otherwise distil a random teacher
            raise ValueError("Teacher model parameters not loaded. Please load a teacher model to distill"
                             " (MultiSeedRunner.load_teacher).")
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
        metrics = {**cm, **um}
        if self.pbt_state is not None:
            metrics = self._pbt_step(self.train_state, self.pbt_state, metrics)
        self._sync()
        learn_time = time.perf_counter() - start

        self.collect_state = cs
        return {k: v.detach().cpu().numpy() for k, v in metrics.items()}, collection_time, learn_time

    # the fused iteration (training_loop.TrainingLoop): the train state, the
    # collect state and the PBT state are its state tree

    def _graph_state(self):
        return self.train_state, self.collect_state, self.pbt_state

    def _set_graph_state(self, state) -> None:
        self.train_state, self.collect_state, self.pbt_state = state

    def _graph_step(self, state):
        ts, cs, pbt = state
        ts, cs, metrics = self._train_step(ts, cs)
        if pbt is not None:
            metrics = self._pbt_step(ts, pbt, metrics)
        return (ts, cs, pbt), metrics

    def _graph_generators(self) -> list:
        return [self.alg.generator] + ([] if self.pbt_state is None else [self.pbt_state.generator])

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
        if "PBT/fitness" in metrics:
            fit, lr = np.asarray(metrics["PBT/fitness"]), np.asarray(metrics["PBT/lr"])
            w.add_scalar("PBT/fitness_best", float(fit.max()), it)
            w.add_scalar("PBT/fitness_median", float(np.median(fit)), it)
            w.add_scalar("PBT/lr_min", float(lr.min()), it)
            w.add_scalar("PBT/lr_max", float(lr.max()), it)
            w.add_scalar("PBT/exploits", float(metrics["PBT/exploits"]), it)
        if ep_count > 0:
            w.add_scalar("Train/mean_reward", float(rew.mean()), it)
            w.add_scalar("Train/mean_reward_std", float(rew.std()), it)
            w.add_scalar("Train/mean_episode_length", float(length.mean()), it)
            w.add_scalar("Train/mean_episode_length_std", float(length.std()), it)

    def _run_eval(self, it: int) -> None:
        """The vmapped deterministic evaluation: every seed rolls its own
        fresh envs with its own policy in one batched rollout; writes the
        cross-seed aggregates of the per-seed mean returns. It draws nothing
        from the training's generators."""
        ts = self.train_state
        m = evaluate_policy(self.env, self.alg.policy, (ts.params, ts.buffers), self.eval_num_steps,
                            eval_seed(self.seed, it), num_seeds=self.num_seeds)
        counts = m["Eval/episode_count"]
        self.writer.add_scalar("Eval/episode_count", float(counts.sum()), it)
        if (counts > 0).all():
            rew, length = m["Eval/mean_reward"], m["Eval/mean_episode_length"]
            self.writer.add_scalar("Eval/mean_reward", float(rew.mean()), it)
            self.writer.add_scalar("Eval/mean_reward_std", float(rew.std()), it)
            self.writer.add_scalar("Eval/best_seed_reward", float(rew.max()), it)
            self.writer.add_scalar("Eval/mean_episode_length", float(length.mean()), it)
            print(f"Evaluation at iteration {it}: mean return {rew.mean():.2f} +/- {rew.std():.2f} over"
                  f" {self.num_seeds} seeds (deterministic policy)")
        else:
            print(f"Evaluation at iteration {it}: {int((counts == 0).sum())}/{self.num_seeds} seeds completed"
                  " no episode within the eval budget (raise eval_num_steps)")

    # ----------------------------------------------------------- checkpoints

    def _rnd_parts(self) -> dict:
        """The RND state of every seed, as a checkpoint holds it."""
        ts = self.train_state
        return {"rnd": {"params": ts.rnd_params, "buffers": ts.rnd_buffers},
                "rnd_opt_state": {"mu": ts.rnd_mu, "nu": ts.rnd_nu, "count": ts.rnd_count}}

    def save(self, path: str, infos=None) -> None:
        """One stacked checkpoint of the whole study (a leading seed axis on
        every tensor): the policies' parameters and normalizer moments, the
        optimizer moments and counts, the learning rates, with RND each
        seed's RND state and predictor optimizer, with PBT its state, the
        iteration, the seed count and ``infos`` (plain data)."""
        ts = self.train_state
        state = {
            "model": {"params": ts.params, "buffers": ts.buffers},
            "opt_state": {"mu": ts.adam_mu, "nu": ts.adam_nu, "count": ts.adam_count},
            "lr": ts.lr,
            "iter": int(self.current_learning_iteration),
            "num_seeds": self.num_seeds,
            "infos": infos,
        }
        if ts.rnd_params is not None:
            state.update(self._rnd_parts())
        if self.pbt_state is not None:
            state["pbt"] = self.pbt_state.checkpoint()
        save_checkpoint(path, state)
        self._upload_model(path)

    def load(self, path: str):
        """Resume the whole study from a :meth:`save` checkpoint, bit for bit
        and in place; returns its ``infos``. A checkpoint of another seed
        count, other policies, another RND setting or another PBT mode raises
        ``ValueError`` before anything is copied."""
        loaded = load_checkpoint(path, map_location=self.device)
        if int(loaded.get("num_seeds", -1)) != self.num_seeds:
            raise ValueError(f"Checkpoint {path!r} holds {loaded.get('num_seeds')} seeds; this runner is"
                             f" configured for {self.num_seeds}.")
        if ("pbt" in loaded) != (self.pbt_state is not None):
            raise ValueError(f"Checkpoint {path!r} and this runner disagree on PBT mode (checkpoint"
                             f" {'has' if 'pbt' in loaded else 'lacks'} PBT state); construct the runner with the"
                             " matching `pbt=` argument.")
        ts = self.train_state
        if ("rnd" in loaded) != (ts.rnd_params is not None):
            raise ValueError(f"Checkpoint {path!r} and this runner disagree on RND (checkpoint"
                             f" {'has' if 'rnd' in loaded else 'lacks'} RND state); construct the runner with the"
                             " matching `rnd_cfg` in the algorithm config.")
        model, opt = loaded["model"], loaded["opt_state"]
        parts = [(ts.params, model["params"], "policy parameters"), (ts.buffers, model["buffers"], "policy buffers"),
                 (ts.adam_mu, opt["mu"], "optimizer mu"), (ts.adam_nu, opt["nu"], "optimizer nu"),
                 ({"count": ts.adam_count, "lr": ts.lr}, {"count": opt["count"], "lr": loaded["lr"]},
                  "optimizer count and learning rate")]
        if ts.rnd_params is not None:
            mine = self._rnd_parts()
            parts += [(mine["rnd"]["params"], loaded["rnd"]["params"], "RND parameters"),
                      (mine["rnd"]["buffers"], loaded["rnd"]["buffers"], "RND buffers"),
                      (mine["rnd_opt_state"], loaded["rnd_opt_state"], "RND optimizer")]
        for current, new, what in parts:
            check_state_compatible(_flat(current), _flat(new), what)
        with torch.no_grad():
            for current, new, _ in parts:
                for k, t in _flat(current).items():
                    t.copy_(_flat(new)[k])
        if self.pbt_state is not None:
            self.pbt_state.restore(loaded["pbt"])
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

    def load_teacher(self, path: str) -> None:
        """Give every seed of a distillation study the same frozen teacher
        from a single-seed RL checkpoint (``OnPolicyRunner.save``), through
        the policy's own remap (``actor`` -> ``teacher``, ``norm_actor`` ->
        ``norm_teacher``, ``memory_a`` -> ``memory_t``); the students keep
        their independent inits. A distillation checkpoint (student
        parameters) or a policy without a teacher raises ``ValueError``."""
        policy = self.alg.policy
        if not hasattr(policy, "loaded_teacher"):
            raise ValueError("load_teacher only applies to student-teacher policies;"
                             f" {type(policy).__name__} has no teacher.")
        model = load_checkpoint(path, map_location=self.device)["model"]
        if any(k.startswith("student.") for k in model):
            raise ValueError(f"Checkpoint {path!r} is a distillation checkpoint (student params present), not an"
                             " RL teacher. Use load()/load_latest() to resume a stacked study.")
        scratch = copy.deepcopy(policy)
        if scratch.load_policy_state(model):
            raise ValueError(f"Checkpoint {path!r} restored the whole policy; expected an RL teacher")
        parts = [m for m, _, _ in scratch._teacher_parts(model)]
        prefixes = [name for name, m in scratch.named_modules() if any(m is p for p in parts)]
        ts = self.train_state
        with torch.no_grad():
            for name, t in {**dict(scratch.named_parameters()), **dict(scratch.named_buffers())}.items():
                if any(name.startswith(prefix + ".") for prefix in prefixes):
                    dst = ts.params[name] if name in ts.params else ts.buffers[name]
                    dst.copy_(t.expand_as(dst))
        policy.loaded_teacher = True

    def save_seed(self, path: str, seed_index: int) -> None:
        """Write one seed as the single-seed checkpoint ``OnPolicyRunner.load``
        takes (its RND state too), so a study's best seed deploys, or trains
        on, through the single-seed runner."""
        if not 0 <= seed_index < self.num_seeds:
            raise ValueError(f"seed_index {seed_index} out of range [0, {self.num_seeds})")
        ts = self.train_state

        def pick(tree: dict) -> dict:
            return {k: v[seed_index].detach().clone() for k, v in tree.items()}

        state = {
            "model": {**pick(ts.params), **pick(ts.buffers)},
            "opt_state": {"mu": pick(ts.adam_mu), "nu": pick(ts.adam_nu),
                          "count": ts.adam_count[seed_index].clone()},
            "lr": ts.lr[seed_index].clone(),
            "iter": int(self.current_learning_iteration),
            "infos": None,
        }
        if ts.rnd_params is not None:
            state["rnd"] = {**pick(ts.rnd_params), **pick(ts.rnd_buffers)}
            # the single-seed runner names the predictor's optimizer state by
            # the predictor's own parameter names
            state["rnd_opt_state"] = {key: {k.removeprefix("predictor."): v for k, v in pick(tree).items()}
                                      for key, tree in (("mu", ts.rnd_mu), ("nu", ts.rnd_nu))}
            state["rnd_opt_state"]["count"] = ts.rnd_count[seed_index].clone()
        save_checkpoint(path, state)


def _flat(tree: dict) -> dict:
    """A nested dict of tensors as one dict by dotted path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[k] = v
    return out
