"""Plain N-link pendulum swing-up: the env the benchmark's reference trains on.

A frozen copy of the arithmetic of the published task (the manipulator
equation of a chain of point masses, solved per substep by an unrolled
Cholesky, semi-implicit Euler, time-limit resets) and of its reset draws (a
splitmix64 hash of per-env keys derived from the seed). The same operations
in the same order as the port's env, so a correct port steps the same
states from the same actions.
"""

from __future__ import annotations

import torch

G_ACC, DAMPING, MAX_TORQUE, MAX_SPEED, DT, SUBSTEPS = 9.81, 0.05, 10.0, 20.0, 0.02, 4


def _int64(v: int) -> int:
    v %= 2**64
    return v - 2**64 if v >= 2**63 else v


_GOLDEN = _int64(0x9E3779B97F4A7C15)
_MIX1 = _int64(0xBF58476D1CE4E5B9)
_MIX2 = _int64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) & ((1 << (64 - n)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def env_keys(seed: int, num_envs: int, device) -> torch.Tensor:
    """Per-env int64 keys of envs ``0 .. num_envs`` for ``seed``."""
    root = _mix(torch.tensor([_int64(int(seed) * _GOLDEN)], dtype=torch.int64, device=device))
    index = torch.arange(1, num_envs + 1, dtype=torch.int64, device=device)
    return _mix(root + index * _GOLDEN)


def hash_draws(keys: torch.Tensor, n: int):
    """``(next keys, bits [N, n])``: splitmix64 of counters 1..n+1 past each key."""
    counters = torch.arange(1, n + 2, dtype=torch.int64, device=keys.device) * _GOLDEN
    z = _mix(keys[:, None] + counters)
    return z[:, n], z[:, :n]


class NLink:
    """``num_envs`` chains of ``num_links`` unit masses, total length 1."""

    def __init__(self, num_envs: int, num_links: int, max_episode_length: int, device):
        self.num_envs, self.num_links, self.max_episode_length = num_envs, num_links, max_episode_length
        f32 = dict(dtype=torch.float32, device=device)
        masses = torch.ones(num_links, **f32)
        self.lengths = torch.ones(num_links, **f32) / num_links
        cummass = torch.flip(torch.cumsum(torch.flip(masses, [0]), 0), [0])
        idx = torch.arange(num_links, device=device)
        K = cummass[torch.maximum(idx[:, None], idx[None, :])]
        self.coup = K * (self.lengths[:, None] * self.lengths[None, :])
        self.gdiag = G_ACC * self.lengths * torch.diagonal(K)
        self.draw_width = torch.tensor([0.2] * num_links + [0.1] * num_links, **f32)
        self.draw_low = torch.tensor([-0.1] * num_links + [-0.05] * num_links, **f32)
        self.total_len = float(self.lengths.sum())

    def _fresh(self, rng):
        rng, bits = hash_draws(rng, 2 * self.num_links)
        draws = _shr(bits, 40).to(torch.float32) * self.draw_width / 2**24 + self.draw_low
        return rng, draws[:, : self.num_links], draws[:, self.num_links:]

    def obs(self, state) -> torch.Tensor:
        return torch.cat([torch.cos(state["theta"]), torch.sin(state["theta"]), 0.1 * state["omega"]], dim=-1)

    def reset(self, seed: int):
        rng, theta, omega = self._fresh(env_keys(seed, self.num_envs, self.lengths.device))
        state = {"theta": theta, "omega": omega, "rng": rng,
                 "episode_length": torch.zeros(self.num_envs, dtype=torch.int32, device=theta.device)}
        return state, self.obs(state)

    def randomize_episode_length(self, state):
        """Episode lengths scattered over ``[0, max_episode_length)``, drawn
        from each env's key, which advances (exact integer bounds)."""
        rng, bits = hash_draws(state["rng"], 1)
        lengths = (_shr(bits[:, 0], 33) * self.max_episode_length) >> 31
        return {**state, "episode_length": lengths.to(torch.int32), "rng": rng}

    def _solve(self, M, rhs):
        n = self.num_links
        a = [[M[:, i, j] for j in range(n)] for i in range(n)]
        low = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(i + 1):
                s = a[i][j]
                for k in range(j):
                    s = s - low[i][k] * low[j][k]
                low[i][j] = torch.sqrt(torch.clamp(s, min=1e-9)) if i == j else s / low[j][j]
        y = [None] * n
        for i in range(n):
            s = rhs[:, i]
            for k in range(i):
                s = s - low[i][k] * y[k]
            y[i] = s / low[i][i]
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - low[k][i] * x[k]
            x[i] = s / low[i][i]
        return torch.stack(x, dim=-1)

    def step(self, state, actions):
        """``(state, obs, reward, done)``; every done is a time-out."""
        u = torch.clamp(actions, -MAX_TORQUE, MAX_TORQUE)
        tau = u - torch.cat([u[:, 1:], torch.zeros_like(u[:, :1])], dim=1)
        theta, omega = state["theta"], state["omega"]
        h = DT / SUBSTEPS
        for _ in range(SUBSTEPS):
            dth = theta[:, :, None] - theta[:, None, :]
            M = self.coup * torch.cos(dth)
            C = torch.sum(self.coup * torch.sin(dth) * (omega**2)[:, None, :], dim=-1)
            rhs = tau - C - self.gdiag * torch.sin(theta) - DAMPING * omega
            omega = torch.clamp(omega + h * self._solve(M, rhs), -MAX_SPEED, MAX_SPEED)
            theta = theta + h * omega
        height = -torch.sum(self.lengths * torch.cos(theta), dim=-1) / self.total_len
        reward = height - 0.05 * torch.mean(omega**2, dim=-1) - 0.01 * torch.mean(u**2, dim=-1)
        episode_length = state["episode_length"] + 1
        done = episode_length >= self.max_episode_length
        rng, theta0, omega0 = self._fresh(state["rng"])
        col = done[:, None]
        state = {"theta": torch.where(col, theta0, theta), "omega": torch.where(col, omega0, omega), "rng": rng,
                 "episode_length": torch.where(done, torch.zeros_like(episode_length), episode_length)}
        return state, self.obs(state), reward, done
