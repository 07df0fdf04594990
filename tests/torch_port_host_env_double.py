"""The port's copy of ``tests/host_env_double.py``: a deterministic,
shard-composable host env on the port's ``HostVecEnv``.

A 2-D point mass whose dynamics and resets depend only on the global env id
and the episode index, with no random draw and no coupling between envs, so
two ranks each stepping ``ShardableHostEnv(n, start_id=rank * n)`` produce
exactly the trajectories of one process stepping ``ShardableHostEnv(2 * n)``
(``tests/test_torch_port_host_dp.py``). It imports no JAX.
"""

from __future__ import annotations

import numpy as np

from rsl_rl_tpu_torch.env.host_env import HostVecEnv


class ShardableHostEnv(HostVecEnv):
    def __init__(self, num_envs: int, start_id: int = 0, max_episode_length: int = 16):
        self.num_envs = num_envs
        self.start_id = start_id
        self.num_actions = 2
        self.max_episode_length = max_episode_length
        self.cfg = {}

    def _reset_state(self, ids: np.ndarray, ep: np.ndarray) -> np.ndarray:
        # a deterministic pseudo-random initial condition from (env id, episode)
        phi = ((ids * 2654435761 + ep * 40503) % 1000) / 1000.0 * 2.0 * np.pi
        return np.stack([np.cos(phi), np.sin(phi)], axis=-1).astype(np.float32)

    def reset(self, seed: int | None = None) -> dict[str, np.ndarray]:
        del seed  # fully deterministic: shard equivalence must not depend on it
        self.ids = np.arange(self.num_envs, dtype=np.int64) + self.start_id
        self.ep = np.zeros(self.num_envs, np.int64)
        self.t = np.zeros(self.num_envs, np.int64)
        self.x = self._reset_state(self.ids, self.ep)
        return {"policy": self.x.copy()}

    def step(self, actions: np.ndarray):
        a = np.clip(np.asarray(actions, np.float32), -1.0, 1.0)
        self.x = 0.9 * self.x + 0.1 * a
        rew = -(self.x**2).sum(-1) - 0.01 * (a**2).sum(-1)
        self.t += 1
        timeout = self.t >= self.max_episode_length
        done = timeout.copy()
        if done.any():
            self.ep[done] += 1
            self.t[done] = 0
            self.x[done] = self._reset_state(self.ids[done], self.ep[done])
        extras = {"time_outs": timeout, "log": {"x_norm": np.abs(self.x).sum(-1)}}
        return {"policy": self.x.copy()}, rew.astype(np.float32), done, extras
