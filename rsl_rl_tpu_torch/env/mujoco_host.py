"""MuJoCo host environments (counterpart of ``rsl_rl_tpu/env/mujoco_host.py``):
any MJCF model through the stateful :class:`~rsl_rl_tpu_torch.env.host_env.HostVecEnv`
API, stepped on the host with one ``MjData`` per env.

- :class:`MuJoCoHostEnv` turns a model into a vectorized training env
  through overridable hooks (episode init, action, per-substep forces,
  obs, reward, termination);
- :class:`MuJoCoNLinkEnv` is the N-link swing-up of ``env/nlink.py`` on
  the real simulator, with the same dynamics to fp32 precision.

``mujoco`` is imported in the constructor, so the package imports without
it.
"""

from __future__ import annotations

import numpy as np

from rsl_rl_tpu_torch.env.host_env import HostVecEnv


def nlink_mjcf(
    num_links: int, lengths: np.ndarray, timestep: float, masses: np.ndarray | None = None
) -> str:
    """MJCF for a planar chain of point masses at link tips, hinges about −y.

    ``θ = 0`` hangs straight down (−z); gravity 9.81 −z; no geoms, so no
    contacts — the conservative dynamics are exactly the manipulator
    equation of ``env/nlink.py``. Point masses carry a 1e-9
    rotational inertia (MuJoCo requires positive-definite body inertia);
    relative to the ``m·l²`` terms this perturbs the mass matrix by ~1e-8,
    below fp32 resolution.
    """
    if masses is None:
        masses = np.ones(num_links)

    def body(i: int) -> str:
        inner = body(i + 1) if i + 1 < num_links else ""
        pos = "0 0 0" if i == 0 else f"0 0 {-lengths[i - 1]}"
        return (
            f'<body name="l{i}" pos="{pos}">'
            f'<joint name="j{i}" type="hinge" axis="0 -1 0" damping="0"/>'
            f'<inertial pos="0 0 {-lengths[i]}" mass="{masses[i]}"'
            f' diaginertia="1e-9 1e-9 1e-9"/>'
            f"{inner}</body>"
        )

    motors = "".join(f'<motor joint="j{i}" gear="1"/>' for i in range(num_links))
    return (
        "<mujoco>"
        f'<option timestep="{timestep}" integrator="Euler" gravity="0 0 -9.81"/>'
        f"<worldbody>{body(0)}</worldbody>"
        f"<actuator>{motors}</actuator>"
        "</mujoco>"
    )


class MuJoCoHostEnv(HostVecEnv):
    """Vectorized training env over ANY MuJoCo model (one ``MjData`` per env,
    stepped serially on host).

    Subclass and override the hooks; the base class owns the contract
    mechanics — episode clocks, the terminal-vs-timeout split (PPO's value
    bootstrap needs it, reference ppo.py:160-164), same-step auto-reset, and
    the ``extras`` protocol.

    Hooks (all receive ONE env's ``MjData``):

    - :meth:`initialize_episode` — write qpos/qvel for a fresh episode
      (default: model keyframe 0 if present, else qpos0 + small noise),
    - :meth:`apply_action` — map the policy action onto the model (default:
      ``data.ctrl[:] = action``),
    - :meth:`before_substep` / :meth:`after_substep` — per-substep hooks
      (applied forces via ``qfrc_applied``, velocity rails, ...),
    - :meth:`compute_obs` — obs-group dict of 1-D arrays (default:
      ``{"policy": [qpos, qvel]}``),
    - :meth:`compute_reward` — scalar reward for the completed step
      (default 0.0 — override for training),
    - :meth:`compute_terminated` — TERMINAL failure (falls etc.; excludes
      time limits, which the base class handles) (default: never).
    """

    def __init__(
        self,
        xml_string: str,
        num_envs: int,
        max_episode_length: int = 1000,
        n_substeps: int = 1,
        seed: int = 0,
        cfg: dict | None = None,
    ):
        import mujoco  # deferred: the package imports without mujoco installed

        self._mujoco = mujoco
        self.model = mujoco.MjModel.from_xml_string(xml_string)
        self.num_envs = num_envs
        self.num_actions = int(self.model.nu)
        self.max_episode_length = int(max_episode_length)
        self.n_substeps = int(n_substeps)
        self.step_dt = float(self.model.opt.timestep) * self.n_substeps
        self.cfg = cfg or {}
        self.data = [mujoco.MjData(self.model) for _ in range(num_envs)]
        self.episode_length_buf = np.zeros(num_envs, np.int32)
        self._rng = np.random.default_rng(seed)
        self.reset()

    # ----------------------------------------------------------------- hooks

    def initialize_episode(self, data, rng: np.random.Generator) -> None:
        if self.model.nkey > 0:
            self._mujoco.mj_resetDataKeyframe(self.model, data, 0)
        else:
            self._mujoco.mj_resetData(self.model, data)
        data.qpos[:] += rng.uniform(-0.01, 0.01, self.model.nq)
        data.qvel[:] += rng.uniform(-0.01, 0.01, self.model.nv)

    def apply_action(self, data, action: np.ndarray) -> None:
        data.ctrl[:] = action

    def before_substep(self, data) -> None:  # noqa: B027 - optional hook
        pass

    def after_substep(self, data) -> None:  # noqa: B027 - optional hook
        pass

    def compute_obs(self, data) -> dict[str, np.ndarray]:
        return {
            "policy": np.concatenate([data.qpos, data.qvel]).astype(np.float32)
        }

    def compute_reward(self, data, action: np.ndarray) -> float:
        return 0.0

    def compute_terminated(self, data) -> bool:
        return False

    # -------------------------------------------------------------- contract

    def _stack_obs(self) -> dict[str, np.ndarray]:
        per_env = [self.compute_obs(d) for d in self.data]
        return {k: np.stack([o[k] for o in per_env]) for k in per_env[0]}

    def reset(self, seed: int | None = None) -> dict[str, np.ndarray]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        for d in self.data:
            self.initialize_episode(d, self._rng)
            self._mujoco.mj_forward(self.model, d)
        self.episode_length_buf[:] = 0
        return self._stack_obs()

    def step(self, actions: np.ndarray):
        actions = np.asarray(actions, np.float64)
        rewards = np.zeros(self.num_envs, np.float32)
        terminated = np.zeros(self.num_envs, bool)
        for i, d in enumerate(self.data):
            self.apply_action(d, actions[i])
            for _ in range(self.n_substeps):
                self.before_substep(d)
                self._mujoco.mj_step(self.model, d)
                self.after_substep(d)
            rewards[i] = self.compute_reward(d, actions[i])
            terminated[i] = self.compute_terminated(d)

        self.episode_length_buf += 1
        time_out = (self.episode_length_buf >= self.max_episode_length) & ~terminated
        done = terminated | time_out
        if done.any():
            for i in np.flatnonzero(done):
                self.initialize_episode(self.data[i], self._rng)
                self._mujoco.mj_forward(self.model, self.data[i])
            self.episode_length_buf[done] = 0

        extras = {"time_outs": time_out, "log": {}}
        return self._stack_obs(), rewards, done, extras


class MuJoCoNLinkEnv(MuJoCoHostEnv):
    """N-link swing-up on real CPU MuJoCo, same task definition as
    ``NLinkPendulum`` (env/nlink.py): same constants, init distribution,
    reward, timeout-only termination and auto-reset.

    Dynamics identity with ``NLinkPendulum`` (held by
    ``tests/test_torch_port_mujoco_host.py``):

    - point masses at link tips, hinge joints — exactly the manipulator
      equation ``NLinkPendulum`` assembles;
    - MuJoCo's ``Euler`` integrator is the same semi-implicit Euler as
      ``NLinkPendulum._substep`` at the same sub-timestep;
    - joint motor torques in MuJoCo's relative coordinates are *identically*
      ``NLinkPendulum``'s joint torques ``u`` (the generalized-force transform
      ``f_q = Aᵀ f_θ`` of ``τ_i = u_i − u_{i+1}`` collapses back to ``u``);
    - ``NLinkPendulum``'s viscous damping acts on ABSOLUTE angular velocity
      ``f_θ = −c·ω``; in relative coordinates that is ``f_q = −c·AᵀA·q̇``,
      applied through ``qfrc_applied`` each substep (explicit, like
      ``NLinkPendulum``'s — MuJoCo treats applied forces explicitly under Euler).

    The only deliberate difference: ``NLinkPendulum`` clips ``ω`` to ``max_speed``
    *between* the velocity and position half-updates of each substep; here
    the clip lands after the full substep (``after_substep``). It is a
    safety rail that never engages below 20 rad/s in normal swing-up
    operation.

    Angles map as ``θ = A·q`` with ``A = tril(ones)`` (absolute = cumulative
    sum of relative hinge angles; hinge axis −y makes positive ``q``
    positive ``θ``).
    """

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
        seed: int = 0,
        cfg: dict | None = None,
    ):
        self.num_links = num_links
        self.lengths = np.ones(num_links) / num_links
        self._total_len = float(self.lengths.sum())
        # absolute-omega damper in relative coords: f_q = −c·(AᵀA)·q̇
        A = np.tril(np.ones((num_links, num_links)))
        self._damp = self.damping * (A.T @ A)
        super().__init__(
            nlink_mjcf(num_links, self.lengths, self.dt / self.n_substeps),
            num_envs,
            max_episode_length=max_episode_length,
            n_substeps=self.n_substeps,
            seed=seed,
            cfg=cfg,
        )

    # ------------------------------------------------------------- coords

    @staticmethod
    def _to_relative(x: np.ndarray) -> np.ndarray:
        """θ (absolute) → q (relative): q_i = θ_i − θ_{i−1} (A⁻¹ = first diff)."""
        return np.diff(x, prepend=0.0)

    @staticmethod
    def _to_absolute(x: np.ndarray) -> np.ndarray:
        """q (relative) → θ (absolute): cumulative sum (A = tril(ones))."""
        return np.cumsum(x)

    def _state(self) -> tuple[np.ndarray, np.ndarray]:
        theta = np.stack([self._to_absolute(d.qpos) for d in self.data])
        omega = np.stack([self._to_absolute(d.qvel) for d in self.data])
        return theta, omega

    def _obs_from(self, theta: np.ndarray, omega: np.ndarray) -> dict[str, np.ndarray]:
        # same obs layout as NLinkPendulum._obs (env/nlink.py:148-152)
        return {
            "policy": np.concatenate(
                [np.cos(theta), np.sin(theta), 0.1 * omega], axis=-1
            ).astype(np.float32)
        }

    # ----------------------------------------------------------------- hooks

    def initialize_episode(self, data, rng: np.random.Generator) -> None:
        # NLinkPendulum's init distribution
        theta = rng.uniform(-0.1, 0.1, self.num_links)
        omega = rng.uniform(-0.05, 0.05, self.num_links)
        data.qpos[:] = self._to_relative(theta)
        data.qvel[:] = self._to_relative(omega)

    def apply_action(self, data, action: np.ndarray) -> None:
        data.ctrl[:] = np.clip(action, -self.max_torque, self.max_torque)

    def before_substep(self, data) -> None:
        data.qfrc_applied[:] = -self._damp @ data.qvel

    def after_substep(self, data) -> None:
        omega = self._to_absolute(data.qvel)
        if np.any(np.abs(omega) > self.max_speed):  # safety rail
            data.qvel[:] = self._to_relative(
                np.clip(omega, -self.max_speed, self.max_speed)
            )

    def compute_obs(self, data) -> dict[str, np.ndarray]:
        theta = self._to_absolute(data.qpos)
        omega = self._to_absolute(data.qvel)
        return {
            "policy": np.concatenate(
                [np.cos(theta), np.sin(theta), 0.1 * omega]
            ).astype(np.float32)
        }

    def compute_reward(self, data, action: np.ndarray) -> float:
        theta = self._to_absolute(data.qpos)
        omega = self._to_absolute(data.qvel)
        height = float(
            -np.sum(self.lengths * np.cos(theta)) / self._total_len
        )
        u = np.clip(action, -self.max_torque, self.max_torque)
        return height - 0.05 * float(np.mean(omega**2)) - 0.01 * float(np.mean(u**2))

    # -------------------------------------------------------------- contract

    def step(self, actions: np.ndarray):
        obs, rewards, done, extras = super().step(actions)
        # the task scalar for the writers, as NLinkPendulum logs it
        extras["log"]["nlink/tip_height"] = (
            -np.sum(self.lengths * np.cos(self._state()[0]), axis=-1)
            / self._total_len
        ).astype(np.float32)
        return obs, rewards, done, extras
