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

Random draws live in the state, as the JAX env's per-env keys do
(``NLinkState.rng``): each env carries a 64-bit key, and ``step`` derives
that env's next key and its reset draws from it with a counter-based hash
(:func:`hash_draws`), so ``step(state, a)`` is a function of its arguments
and the rows of a stacked state step as the state made of those rows. The
hash is not JAX's threefry, so the draws differ from the JAX env's.

``step`` takes its path from the state's device: on a CUDA device the whole
step is one launch of a hand-written kernel (``csrc/nlink.cu``, through
``ops/nlink_step.py``) that rounds each op as the plain step does on the
card; elsewhere the plain PyTorch step below runs op by op.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv, as_episode_length, check_episode_length
from rsl_rl_tpu_torch.ops import nlink_step
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.registry import register


def _int64(v: int) -> int:
    """The signed int64 of a 64-bit pattern."""
    v %= 2**64
    return v - 2**64 if v >= 2**63 else v


#: the reset draws' ranges ``(low, width)``: theta in [-0.1, 0.1), omega in [-0.05, 0.05)
_THETA_DRAW, _OMEGA_DRAW = (-0.1, 0.2), (-0.05, 0.1)
#: the floor of the Cholesky factor's pivots before their square roots
_PIVOT_FLOOR = 1e-9
#: the reward's costs on the mean squared joint speed and the mean squared torque
_SPEED_COST, _EFFORT_COST = 0.05, 0.01
#: splitmix64's increment and finalizer multipliers (as signed int64)
_GOLDEN = _int64(0x9E3779B97F4A7C15)
_MIX1 = _int64(0xBF58476D1CE4E5B9)
_MIX2 = _int64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's ``>>`` is arithmetic)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 bit patterns (products wrap mod 2^64)."""
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


@functools.lru_cache(maxsize=None)
def _counters(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(1, n + 2, dtype=torch.int64, device=device) * _GOLDEN


def hash_draws(keys: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(next_keys [N], bits [N, n])`` from per-env keys ``[N]`` int64: the
    splitmix64 outputs of counters 1..n+1 past each key; the last becomes the
    env's next key. Plain integer ops, the same bits on any device."""
    z = _mix(keys[:, None] + _counters(n, keys.device))
    return z[:, n], z[:, :n]


def uniform_draws(bits: torch.Tensor, low, width) -> torch.Tensor:
    """fp32 uniforms in ``[low, low + width)`` from the top 24 bits of each
    64-bit draw of :func:`hash_draws`."""
    return _shr(bits, 40).to(torch.float32) * width / 2**24 + low


def random_episode_lengths(state: EnvState, max_episode_length) -> EnvState:
    """``state`` with its episode lengths scattered over ``[0,
    max_episode_length_i)`` (``init_at_random_ep_len``), drawn from each
    env's key ``state.rng``, which advances."""
    rng, bits = hash_draws(state.rng, 1)
    maxlen = torch.as_tensor(max_episode_length, dtype=torch.int64, device=state.rng.device)
    lengths = (_shr(bits[:, 0], 33) * maxlen) >> 31  # exact integer bounds
    return dataclasses.replace(state, episode_length=lengths.to(torch.int32), rng=rng)


def env_keys(seed: int, num_envs: int, device=None, env_offset: int = 0) -> torch.Tensor:
    """The per-env keys ``[num_envs]`` int64 that ``reset(seed)`` starts
    from, of the envs ``env_offset ..`` of the global env index: a shard's
    key ``i`` is the whole env's key ``env_offset + i`` (data parallelism)."""
    root = _mix(torch.tensor([_int64(int(seed) * _GOLDEN)], dtype=torch.int64, device=device))
    index = torch.arange(env_offset + 1, env_offset + num_envs + 1, dtype=torch.int64, device=device)
    return _mix(root + index * _GOLDEN)


@dataclass
class NLinkState(EnvState):
    theta: torch.Tensor  # [N, L] absolute link angles (0 = hanging down)
    omega: torch.Tensor  # [N, L] angular velocities
    rng: torch.Tensor  # [N] int64 per-env keys of the reset draws


@register("env")
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
        self.step_dt = self.dt  # the env step's seconds, which resolve_rnd_config reads
        self.max_episode_length = as_episode_length(max_episode_length, self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.masses = torch.ones(num_links, **f32)
        self.lengths = torch.ones(num_links, **f32) / num_links
        cummass = torch.flip(torch.cumsum(torch.flip(self.masses, [0]), 0), [0])
        idx = torch.arange(num_links, device=self.device)
        K = cummass[torch.maximum(idx[:, None], idx[None, :])]  # [L, L]
        self._coup = K * (self.lengths[:, None] * self.lengths[None, :])
        self._gdiag = self.g * self.lengths * torch.diagonal(K)
        (theta_low, theta_width), (omega_low, omega_width) = _THETA_DRAW, _OMEGA_DRAW
        self._draw_width = torch.tensor([theta_width] * num_links + [omega_width] * num_links, **f32)
        self._draw_low = torch.tensor([theta_low] * num_links + [omega_low] * num_links, **f32)
        self._total_len = float(self.lengths.sum())
        #: the hash draws a reset takes: theta's and omega's 2L, and a
        #: subclass's per-episode fields past them (:meth:`_extra_fields`)
        self.reset_draws = 2 * num_links

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
                    low[i][j] = torch.sqrt(torch.clamp(s, min=_PIVOT_FLOOR))
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

    def _accel(self, theta: torch.Tensor, omega: torch.Tensor, tau: torch.Tensor, coup, gdiag) -> torch.Tensor:
        """q̈ from the manipulator equation; ``theta``/``omega``/``tau``
        ``[N, L]``, the couplings ``K_ij l_i l_j`` and ``g l_i K_ii`` of
        :meth:`_coupling`."""
        dth = theta[:, :, None] - theta[:, None, :]  # [N, L, L] θ_i − θ_j
        M = coup * torch.cos(dth)
        C = torch.sum(coup * torch.sin(dth) * (omega**2)[:, None, :], dim=-1)
        G = gdiag * torch.sin(theta)
        rhs = tau - C - G - self.damping * omega
        return self._solve_spd(M, rhs)

    def _coupling(self, state: NLinkState):
        """``(K_ij l_i l_j, g l_i K_ii)`` of the state's plants: the
        constructor's ``[L, L]`` and ``[L]`` here, a per-env batch in
        :class:`DomainRandomizedNLink`."""
        return self._coup, self._gdiag

    def _joint_to_generalized(self, u: torch.Tensor) -> torch.Tensor:
        """τ_i = u_i − u_{i+1} (a joint torque acts on both adjacent links)."""
        return u - torch.cat([u[:, 1:], torch.zeros_like(u[:, :1])], dim=1)

    def _substep(self, theta, omega, tau, h, coup, gdiag):
        """One semi-implicit Euler substep."""
        omega = omega + h * self._accel(theta, omega, tau, coup, gdiag)
        omega = torch.clamp(omega, -self.max_speed, self.max_speed)
        theta = theta + h * omega
        return theta, omega

    def _tip_height(self, theta: torch.Tensor) -> torch.Tensor:
        return -torch.sum(self.lengths * torch.cos(theta), dim=-1)

    def _masses_of(self, state: NLinkState) -> torch.Tensor:
        """Link masses: ``[L]``, or ``[N, L]`` in the domain-randomized subclass."""
        return self.masses

    def total_energy(self, state: NLinkState) -> torch.Tensor:
        """Mechanical energy per env ``[N]`` (for integrator checks)."""
        masses = self._masses_of(state)
        x_dot = torch.cumsum(self.lengths * state.omega * torch.cos(state.theta), dim=-1)
        y_dot = torch.cumsum(self.lengths * state.omega * torch.sin(state.theta), dim=-1)
        y = torch.cumsum(-self.lengths * torch.cos(state.theta), dim=-1)
        kinetic = 0.5 * torch.sum(masses * (x_dot**2 + y_dot**2), dim=-1)
        return kinetic + self.g * torch.sum(masses * y, dim=-1)

    # ------------------------------------------------------------- contract

    def _obs(self, state: NLinkState) -> dict[str, torch.Tensor]:
        obs = torch.cat(
            [torch.cos(state.theta), torch.sin(state.theta), 0.1 * state.omega], dim=-1
        )
        return {"policy": obs}

    def _sample_init(self, rng: torch.Tensor) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Each env's next key and the fields of a fresh episode drawn from
        its key, ``{"theta", "omega"}`` (fp32 uniforms from the top 24 bits
        of each of the first ``2L`` draws) and :meth:`_extra_fields` of the
        rest of its :attr:`reset_draws`."""
        L = self.num_links
        rng, bits = hash_draws(rng, self.reset_draws)
        draws = uniform_draws(bits[:, : 2 * L], self._draw_low, self._draw_width)
        return rng, {"theta": draws[:, :L], "omega": draws[:, L:], **self._extra_fields(bits[:, 2 * L :])}

    def _extra_fields(self, bits: torch.Tensor) -> dict[str, torch.Tensor]:
        """A subclass's per-episode fields from a reset's draws past theta's
        and omega's, ``[N, reset_draws - 2L]`` int64 bit patterns: none here."""
        return {}

    def _next_state(self, state: NLinkState | None, fresh: dict, done: torch.Tensor | None,
                    **fields) -> NLinkState:
        """The state after a step (``done`` the envs that reset) or a reset
        (``state`` and ``done`` None): the subclass's hook for its
        per-episode fields."""
        return NLinkState(**fields)

    def reset(self, seed: int = 0, num_envs: int | None = None, env_offset: int = 0) -> tuple[NLinkState, dict[str, torch.Tensor]]:
        num_envs = self.num_envs if num_envs is None else int(num_envs)
        check_episode_length(self.max_episode_length, num_envs)
        rng, fresh = self._sample_init(env_keys(seed, num_envs, self.device, env_offset))
        state = self._next_state(
            None, fresh, None,
            episode_length=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            theta=fresh["theta"],
            omega=fresh["omega"],
            rng=rng,
        )
        return state, self._obs(state)

    def randomize_episode_length(self, state: NLinkState) -> NLinkState:
        """Scatter the episode lengths over ``[0, max_episode_length_i)``
        (``init_at_random_ep_len``), drawn from each env's key, which advances."""
        return random_episode_lengths(state, self.max_episode_length)

    def step(self, state: NLinkState, actions: torch.Tensor):
        """The plain step below on the CPU; on a CUDA device one launch of
        the step kernel, which gives the plain step's bits there."""
        if state.theta.is_cuda:
            return self._step_kernel(state, actions)
        return self._step_plain(state, actions)

    def _step_kernel(self, state: NLinkState, actions: torch.Tensor):
        coup, gdiag = self._coupling(state)
        out = nlink_step.step(
            state.theta, state.omega, actions, state.episode_length, state.rng, self.max_episode_length,
            coup, gdiag, self.lengths, reset_draws=self.reset_draws, n_substeps=self.n_substeps,
            h=self.dt / self.n_substeps, max_torque=self.max_torque, max_speed=self.max_speed,
            damping=self.damping, total_len=self._total_len, theta_range=_THETA_DRAW, omega_range=_OMEGA_DRAW,
            pivot_floor=_PIVOT_FLOOR, speed_cost=_SPEED_COST, effort_cost=_EFFORT_COST)
        state = self._next_state(
            state, self._extra_fields(out.extra_bits), out.done,
            episode_length=out.episode_length, theta=out.theta, omega=out.omega, rng=out.rng,
        )
        extras = {"time_outs": out.done, "log": {"nlink/tip_height": out.height}}
        return state, self._obs(state), out.reward, out.done, extras

    def _step_plain(self, state: NLinkState, actions: torch.Tensor):
        u = torch.clamp(actions, -self.max_torque, self.max_torque)
        tau = self._joint_to_generalized(u)
        theta, omega = state.theta, state.omega
        coup, gdiag = self._coupling(state)
        h = self.dt / self.n_substeps
        for _ in range(self.n_substeps):
            theta, omega = self._substep(theta, omega, tau, h, coup, gdiag)

        height = self._tip_height(theta) / self._total_len  # [-1, 1]
        reward = (
            height
            - _SPEED_COST * torch.mean(omega**2, dim=-1)
            - _EFFORT_COST * torch.mean(u**2, dim=-1)
        )

        episode_length = state.episode_length + 1
        time_out = episode_length >= self.max_episode_length
        done = time_out  # no terminal states, only truncation

        # like the JAX env, every env's key advances and draws reset states,
        # kept where the env is done (no host sync on whether any env is done)
        rng, fresh = self._sample_init(state.rng)
        done_col = done[:, None]
        state = self._next_state(
            state, fresh, done,
            episode_length=torch.where(done, torch.zeros_like(episode_length), episode_length),
            theta=torch.where(done_col, fresh["theta"], theta),
            omega=torch.where(done_col, fresh["omega"], omega),
            rng=rng,
        )
        extras = {"time_outs": time_out, "log": {"nlink/tip_height": height}}
        return state, self._obs(state), reward, done, extras


@register("env")
class PartiallyObservableNLink(NLinkPendulum):
    """N-link swing-up with the angular velocities hidden from the policy:
    the observation is ``[cos θ, sin θ]`` only (``2L`` dims), so a policy
    must estimate ``ω`` from history (the recurrent parity task)."""

    def _obs(self, state: NLinkState) -> dict[str, torch.Tensor]:
        return {"policy": torch.cat([torch.cos(state.theta), torch.sin(state.theta)], dim=-1)}


@dataclass
class DomainRandomizedNLinkState(NLinkState):
    mass_scale: torch.Tensor  # [N, L] per-episode multiplicative mass scales


@register("env")
class DomainRandomizedNLink(NLinkPendulum):
    """N-link swing-up with per-episode domain randomization of the link
    masses (counterpart of the JAX package's ``DomainRandomizedNLink``).

    Every episode each env draws independent log-uniform mass scales in
    ``mass_scale_range``; the ``[N, L]`` scales ride the env state, the
    coupling becomes a per-env ``[N, L, L]`` batch, and a reset resamples
    them where the env is done. They are drawn from the env's key with its
    reset state, ``L`` more draws of the same hash, so the card and the CPU
    draw the same bits and the env holds no generator.

    Obs groups: ``"policy"`` is the base observation (the policy does not
    see the scales); ``"privileged"`` appends ``log(mass_scale)`` for critics
    and teachers.
    """

    def __init__(
        self,
        num_envs: int,
        num_links: int = 5,
        max_episode_length: int = 400,
        mass_scale_range: tuple[float, float] = (0.5, 2.0),
        device: str | torch.device = "cuda",
    ):
        super().__init__(num_envs, num_links, max_episode_length, device)
        self.reset_draws = 3 * num_links  # and L more for mass_scale
        lo, hi = mass_scale_range
        if not 0 < lo <= hi:
            raise ValueError(f"mass_scale_range must satisfy 0 < lo <= hi, got {mass_scale_range}")
        self.mass_scale_range = (float(lo), float(hi))
        # the log-uniform draw's bounds, in fp32 as the JAX env computes them
        self._log_lo, self._log_hi = (torch.log(torch.tensor(v, dtype=torch.float32)).to(self.device)
                                      for v in self.mass_scale_range)
        idx = torch.arange(num_links, device=self.device)
        self._maxidx = torch.maximum(idx[:, None], idx[None, :])  # [L, L]
        self._ll = self.lengths[:, None] * self.lengths[None, :]  # [L, L]

    # --------------------------------------------------------- randomization

    def _extra_fields(self, bits: torch.Tensor) -> dict[str, torch.Tensor]:
        """``mass_scale``, log-uniform in ``mass_scale_range``, from the ``L``
        draws past the base reset state's ``2L``."""
        u = _shr(bits, 40).to(torch.float32) / 2**24
        # exp in fp64, rounded to fp32: the same bits on the CPU and the card
        # (their fp32 exp differ in the last place)
        mass_scale = torch.exp((self._log_lo + u * (self._log_hi - self._log_lo)).double()).float()
        return {"mass_scale": mass_scale}

    def _next_state(self, state, fresh, done, **fields) -> DomainRandomizedNLinkState:
        mass_scale = fresh["mass_scale"]
        if state is not None:
            mass_scale = torch.where(done[:, None], mass_scale, state.mass_scale)
        return DomainRandomizedNLinkState(**fields, mass_scale=mass_scale)

    def _K_of(self, mass_scale: torch.Tensor) -> torch.Tensor:
        """Per-env coupling ``K_ij = Σ_{k≥max(i,j)} m_k`` ``[N, L, L]`` for
        ``[N, L]`` mass scales."""
        m = self.masses * mass_scale
        cummass = torch.flip(torch.cumsum(torch.flip(m, [-1]), -1), [-1])  # [N, L]
        return cummass[:, self._maxidx]

    def _coupling(self, state: DomainRandomizedNLinkState):
        K = self._K_of(state.mass_scale)
        return K * self._ll, self.g * self.lengths * torch.diagonal(K, dim1=-2, dim2=-1)

    def _masses_of(self, state: DomainRandomizedNLinkState) -> torch.Tensor:
        return self.masses * state.mass_scale

    # -------------------------------------------------------------- contract

    def _obs(self, state: DomainRandomizedNLinkState) -> dict[str, torch.Tensor]:
        obs = super()._obs(state)
        obs["privileged"] = torch.cat([obs["policy"], torch.log(state.mass_scale)], dim=-1)
        return obs
