"""Shared pieces of the host collection loops (counterpart of
``rsl_rl_tpu/algorithms/host_collect.py``).

PPO's and Distillation's host loops (the policy acts on its device, the env
steps on the host) share their episode bookkeeping, the extras means and the
stacking of the window; only what they record a step differs.
"""

from __future__ import annotations

import numpy as np
import torch

from rsl_rl_tpu_torch.algorithms.ppo import ACC_KEYS, EpisodeStats
from rsl_rl_tpu_torch.utils import trace

#: the phases of a host window, booked to the tracer's record of the
#: iteration (``utils/trace.py``): the policy's act step on its device and
#: the step processing (normalizers, rewards, carry resets) on the device,
#: each between two device stamps, and the action's copy to the host, the
#: env's step and the copies of obs, rewards and dones to the device, each on
#: the host clock
PHASES = ("act", "to_host", "env_step", "to_device", "process")


def host_step(env, action: torch.Tensor, device: torch.device):
    """Copy ``action`` to the host, step the host env, and copy what it
    returns to ``device``: ``(obs, rewards, dones, time_outs)`` as tensors
    (obs and rewards fp32, dones bool, time-outs fp32, zero where the env
    reports none), then the host's ``(rewards, dones, extras)``."""
    with trace.host_phase("to_host"):
        action_np = action.cpu().numpy()
    with trace.host_phase("env_step"):
        obs_np, rew_np, done_np, extras = env.step(action_np)
    with trace.host_phase("to_device"):
        rew_np = np.asarray(rew_np, np.float32)
        done_np = np.asarray(done_np, bool)
        time_outs = np.asarray(extras.get("time_outs", np.zeros_like(done_np)), np.float32)
        obs = {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in obs_np.items()}
        tensors = (obs, torch.as_tensor(rew_np, device=device), torch.as_tensor(done_np, device=device),
                   torch.as_tensor(time_outs, device=device))
    return tensors, (rew_np, done_np, extras)


class HostEpisodeTracker:
    """A numpy mirror of the on-device episode bookkeeping
    (``algorithms.ppo.step_episode_stats``), fed the host env's numpy
    rewards and dones, so the loop reads nothing back from the device for
    it."""

    def __init__(self, stats: EpisodeStats, device):
        self.device = device
        self.cur_rew = stats.cur_reward_sum.cpu().numpy().copy()
        self.cur_len = stats.cur_episode_length.cpu().numpy().copy()
        self.cur_erew = stats.cur_ereward_sum.cpu().numpy().copy()
        self.cur_irew = stats.cur_ireward_sum.cpu().numpy().copy()
        self.acc = {k: 0.0 for k in ACC_KEYS}
        self.log_acc: dict[str, float] = {}
        self.log_counts: dict[str, int] = {}

    def step(self, rew: np.ndarray, irew: np.ndarray, done: np.ndarray, extras: dict) -> None:
        self.cur_rew += rew + irew
        self.cur_erew += rew
        self.cur_irew += irew
        self.cur_len += 1.0
        if done.any():
            d = done.astype(bool)
            for key, cur in (("ep_reward_sum", self.cur_rew), ("ep_length_sum", self.cur_len),
                             ("ep_ereward_sum", self.cur_erew), ("ep_ireward_sum", self.cur_irew)):
                self.acc[key] += float(cur[d].sum())
                cur[d] = 0.0
            self.acc["ep_count"] += float(d.sum())
        # "episode" takes precedence over "log" (the reference's elif); a
        # key's mean is over the steps it was present in, since host envs
        # may emit some keys only at episode ends
        group = extras["episode"] if "episode" in extras else extras.get("log")
        for k, v in (group or {}).items():
            self.log_acc[k] = self.log_acc.get(k, 0.0) + float(np.mean(v))
            self.log_counts[k] = self.log_counts.get(k, 0) + 1

    def stats(self) -> EpisodeStats:
        """The running episode sums as an ``EpisodeStats`` on the device."""
        return EpisodeStats(*(torch.as_tensor(x, dtype=torch.float32, device=self.device)
                              for x in (self.cur_rew, self.cur_len, self.cur_erew, self.cur_irew)))

    def metrics(self) -> dict[str, torch.Tensor]:
        """The window's episode totals and the extras means, as fp32 scalars
        on the device."""
        out = {k: torch.tensor(v, dtype=torch.float32, device=self.device) for k, v in self.acc.items()}
        for k, v in self.log_acc.items():
            out[f"extras/{k}"] = torch.tensor(v / self.log_counts[k], dtype=torch.float32, device=self.device)
        return out


def stack_trajectory(traj: dict[str, list]) -> dict:
    """Stack a window's per-step lists into time-major tensors (``obs``
    entries are obs-group dicts)."""
    out = {}
    for k, xs in traj.items():
        out[k] = {g: torch.stack([x[g] for x in xs]) for g in xs[0]} if k == "obs" else torch.stack(xs)
    return out
