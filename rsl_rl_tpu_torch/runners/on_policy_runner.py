"""On-policy training runner (counterpart of
``rsl_rl_tpu/runners/on_policy_runner.py``): config -> policy and algorithm by
registered name, then ``learn(n)`` alternates a collection window and an
update and prints the console log.

Logging writers, checkpoints, evaluation and multi-iteration dispatch are not
ported yet; passing a ``log_dir`` raises.
"""

from __future__ import annotations

import time
from collections import deque

import torch

import rsl_rl_tpu_torch.algorithms  # noqa: F401  (registers the algorithms)
import rsl_rl_tpu_torch.modules  # noqa: F401  (registers the policies)
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import resolve
from rsl_rl_tpu_torch.utils.resolvers import resolve_obs_groups


class OnPolicyRunner:
    """Trains an actor-critic with an on-policy algorithm on one device."""

    training_type = "rl"

    def __init__(self, env, train_cfg: dict, log_dir: str | None = None,
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
        self.num_steps_per_env = self.cfg["num_steps_per_env"]
        seed = int(self.cfg.get("seed", 1))

        env_state, obs = env.reset(seed)
        self.cfg["obs_groups"] = resolve_obs_groups(obs, self.cfg["obs_groups"], ["critic"])
        policy_class = resolve("policy", self.policy_cfg.pop("class_name"))
        policy = policy_class(obs, self.cfg["obs_groups"], env.num_actions,
                              device=self.device, seed=seed, **self.policy_cfg)
        alg_class = resolve("algorithm", self.alg_cfg.pop("class_name"))
        self.alg = alg_class(policy, seed=seed + 1, **self.alg_cfg)
        self.collect_state = self.alg.init_collect_state(env_state, obs, env.num_envs)

        self.tot_timesteps = 0
        self.tot_time = 0.0
        self.current_learning_iteration = 0
        #: one dict per finished iteration: collection_s, learn_s, steps_per_s, metrics
        self.history: list[dict] = []
        self._ep_window = deque()  # (rew_sum, len_sum, count) per iteration

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def learn(self, num_learning_iterations: int, init_at_random_ep_len: bool = False) -> None:
        if init_at_random_ep_len:
            state = self.collect_state.env_state
            maxlen = torch.as_tensor(self.env.max_episode_length, device=self.device)
            draw = torch.rand(self.env.num_envs, device=self.device, generator=self.env.generator)
            state.episode_length = torch.floor(draw * maxlen).to(torch.int32)

        start_iter = self.current_learning_iteration
        tot_iter = start_iter + num_learning_iterations
        for it in range(start_iter, tot_iter):
            start = time.perf_counter()
            cs, rollout, cm = self.alg.collect(self.env, self.collect_state, self.num_steps_per_env)
            self._sync()
            collection_time = time.perf_counter() - start

            start = time.perf_counter()
            cs, um = self.alg.update(cs, rollout)
            self._sync()
            learn_time = time.perf_counter() - start

            self.collect_state = cs
            self.current_learning_iteration = it
            metrics = {k: float(v) for k, v in {**cm, **um}.items()}
            self._log(it, start_iter, tot_iter, metrics, collection_time, learn_time)

    def _episode_window_stats(self, metrics: dict) -> tuple[float, float, float]:
        """Means over a trailing window of about 100 finished episodes."""
        self._ep_window.append(
            (metrics["ep_reward_sum"], metrics["ep_length_sum"], metrics["ep_count"])
        )
        while len(self._ep_window) > 1 and sum(e[2] for e in self._ep_window) - self._ep_window[0][2] >= 100:
            self._ep_window.popleft()
        count = sum(e[2] for e in self._ep_window)
        if count == 0:
            return 0.0, 0.0, 0.0
        return (sum(e[0] for e in self._ep_window) / count,
                sum(e[1] for e in self._ep_window) / count, count)

    def _log(self, it, start_iter, tot_iter, metrics, collection_time, learn_time, width=80, pad=35):
        collection_size = self.num_steps_per_env * self.env.num_envs
        self.tot_timesteps += collection_size
        iteration_time = collection_time + learn_time
        self.tot_time += iteration_time
        fps = collection_size / iteration_time
        self.history.append({
            "iteration": it,
            "collection_s": collection_time,
            "learn_s": learn_time,
            "steps_per_s": fps,
            "metrics": metrics,
        })
        mean_reward, mean_ep_len, ep_count = self._episode_window_stats(metrics)
        header = f" \033[1m Learning iteration {it}/{tot_iter} \033[0m "
        log = (
            f"{'#' * width}\n{header.center(width, ' ')}\n\n"
            f"{'Computation:':>{pad}} {fps:.0f} steps/s (collection: {collection_time:.3f}s,"
            f" learning {learn_time:.3f}s)\n"
            f"{'Mean action noise std:':>{pad}} {metrics['Policy/mean_noise_std']:.2f}\n"
        )
        for key, value in metrics.items():
            name = key.removeprefix("Loss/")
            if key.startswith("Loss/") and name not in ("kl", "learning_rate"):
                log += f"{f'Mean {name} loss:':>{pad}} {value:.4f}\n"
        if ep_count > 0:
            log += f"{'Mean reward:':>{pad}} {mean_reward:.2f}\n"
            log += f"{'Mean episode length:':>{pad}} {mean_ep_len:.2f}\n"
        eta = self.tot_time / (it - start_iter + 1) * (tot_iter - it - 1)
        log += (
            f"{'-' * width}\n"
            f"{'Total timesteps:':>{pad}} {self.tot_timesteps}\n"
            f"{'Iteration time:':>{pad}} {iteration_time:.2f}s\n"
            f"{'Time elapsed:':>{pad}} {time.strftime('%H:%M:%S', time.gmtime(self.tot_time))}\n"
            f"{'ETA:':>{pad}} {time.strftime('%H:%M:%S', time.gmtime(eta))}\n"
        )
        print(log)
