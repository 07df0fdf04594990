"""N-link pendulum swing-up (counterpart of ``rsl_rl_tpu/env/nlink.py``).

Every step assembles the manipulator equation ``M(q)·q̈ = τ − C(q,q̇) − G(q)``
for an N-link chain of point masses and solves the batched ``[L, L]`` SPD
system per substep with an unrolled Cholesky, exactly as the JAX env does:

    M_ij = K_ij l_i l_j cos(θ_i − θ_j)
    C_i  = Σ_j K_ij l_i l_j sin(θ_i − θ_j) ω_j²
    G_i  = g l_i K_ii sin(θ_i)

with ``K_ij = Σ_{k≥max(i,j)} m_k``, joint torques ``τ_i = u_i − u_{i+1}``,
viscous damping and semi-implicit Euler over ``n_substeps``. Episodes end by
time limit only, so every done is a timeout.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv, as_episode_length
from rsl_rl_tpu_torch.utils.device import resolve_device


@dataclass
class NLinkState(EnvState):
    theta: torch.Tensor  # [N, L] absolute link angles (0 = hanging down)
    omega: torch.Tensor  # [N, L] angular velocities


class NLinkPendulum(VecEnv):
    """Torque-controlled N-link pendulum chain, vectorized over ``num_envs``."""

    g = 9.81
    damping = 0.05
    max_torque = 10.0
    max_speed = 20.0
    dt = 0.02
    n_substeps = 4

    def __init__(
        self,
        num_envs: int,
        num_links: int = 5,
        max_episode_length: int = 400,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.num_envs = num_envs
        self.num_links = num_links
        self.num_actions = num_links
        self.max_episode_length = as_episode_length(max_episode_length, self.device)
        self.generator = torch.Generator(device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.masses = torch.ones(num_links, **f32)
        self.lengths = torch.ones(num_links, **f32) / num_links
        cummass = torch.flip(torch.cumsum(torch.flip(self.masses, [0]), 0), [0])
        idx = torch.arange(num_links, device=self.device)
        K = cummass[torch.maximum(idx[:, None], idx[None, :])]  # [L, L]
        self._coup = K * (self.lengths[:, None] * self.lengths[None, :])
        self._gdiag = self.g * self.lengths * torch.diagonal(K)
        self._total_len = float(self.lengths.sum())

    # ------------------------------------------------------------- dynamics

    def _solve_spd(self, M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``M x = rhs`` for tiny SPD systems, ``[N, L, L] @ [N, L]``,
        by a Cholesky unrolled over the link dimension (each matrix entry is
        one ``[N]`` vector), the same arithmetic as the JAX env."""
        n = self.num_links
        a = [[M[:, i, j] for j in range(n)] for i in range(n)]
        low = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(i + 1):
                s = a[i][j]
                for k in range(j):
                    s = s - low[i][k] * low[j][k]
                if i == j:
                    low[i][j] = torch.sqrt(torch.clamp(s, min=1e-9))
                else:
                    low[i][j] = s / low[j][j]
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

    def _accel(self, theta: torch.Tensor, omega: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        """q̈ from the manipulator equation; all arguments ``[N, L]``."""
        dth = theta[:, :, None] - theta[:, None, :]  # [N, L, L] θ_i − θ_j
        M = self._coup * torch.cos(dth)
        C = torch.sum(self._coup * torch.sin(dth) * (omega**2)[:, None, :], dim=-1)
        G = self._gdiag * torch.sin(theta)
        rhs = tau - C - G - self.damping * omega
        return self._solve_spd(M, rhs)

    def _joint_to_generalized(self, u: torch.Tensor) -> torch.Tensor:
        """τ_i = u_i − u_{i+1} (a joint torque acts on both adjacent links)."""
        return u - torch.cat([u[:, 1:], torch.zeros_like(u[:, :1])], dim=1)

    def _substep(self, theta, omega, tau, h):
        """One semi-implicit Euler substep."""
        omega = omega + h * self._accel(theta, omega, tau)
        omega = torch.clamp(omega, -self.max_speed, self.max_speed)
        theta = theta + h * omega
        return theta, omega

    def _tip_height(self, theta: torch.Tensor) -> torch.Tensor:
        return -torch.sum(self.lengths * torch.cos(theta), dim=-1)

    # ------------------------------------------------------------- contract

    def _obs(self, state: NLinkState) -> dict[str, torch.Tensor]:
        obs = torch.cat(
            [torch.cos(state.theta), torch.sin(state.theta), 0.1 * state.omega], dim=-1
        )
        return {"policy": obs}

    def _sample_init(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        shape = (n, self.num_links)
        kw = dict(dtype=torch.float32, device=self.device, generator=self.generator)
        theta = torch.rand(shape, **kw) * 0.2 - 0.1
        omega = torch.rand(shape, **kw) * 0.1 - 0.05
        return theta, omega

    def reset(self, seed: int = 0) -> tuple[NLinkState, dict[str, torch.Tensor]]:
        self.generator.manual_seed(int(seed))
        theta, omega = self._sample_init(self.num_envs)
        state = NLinkState(
            episode_length=torch.zeros(self.num_envs, dtype=torch.int32, device=self.device),
            theta=theta,
            omega=omega,
        )
        return state, self._obs(state)

    def step(self, state: NLinkState, actions: torch.Tensor):
        u = torch.clamp(actions, -self.max_torque, self.max_torque)
        tau = self._joint_to_generalized(u)
        theta, omega = state.theta, state.omega
        h = self.dt / self.n_substeps
        for _ in range(self.n_substeps):
            theta, omega = self._substep(theta, omega, tau, h)

        height = self._tip_height(theta) / self._total_len  # [-1, 1]
        reward = (
            height
            - 0.05 * torch.mean(omega**2, dim=-1)
            - 0.01 * torch.mean(u**2, dim=-1)
        )

        episode_length = state.episode_length + 1
        time_out = episode_length >= self.max_episode_length
        done = time_out  # no terminal states, only truncation

        # like the JAX env, draw reset states for every env and keep those of
        # the done envs (no host sync on whether any env is done)
        reset_theta, reset_omega = self._sample_init(self.num_envs)
        done_col = done[:, None]
        state = NLinkState(
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            theta=torch.where(done_col, reset_theta, theta),
            omega=torch.where(done_col, reset_omega, omega),
        )
        extras = {"time_outs": time_out, "log": {"nlink/tip_height": height}}
        return state, self._obs(state), reward, done, extras
