"""Host-side (stateful, numpy) environments (counterpart of
``rsl_rl_tpu/env/host_env.py``).

External simulators (Isaac Lab, Legged Gym, MuJoCo) keep their own state and
step on the host. They implement the stateful :class:`HostVecEnv` API, and
the runner switches to the host collection loop: the policy acts and the
step is processed on the policy's device, the env steps on the host, and the
window is stacked into the same time-major ``Rollout`` the unchanged update
consumes (``PPO.make_host_collect_fn``, ``Distillation.make_host_collect_fn``).

The runners detect a host env by its ``is_jax = False`` attribute, as the
JAX package's runners do, so one host env class trains under both packages.

:class:`GymVecEnv` adapts Gymnasium vectorized environments, with the
truncation -> ``time_outs`` mapping the value bootstrap needs. ``gymnasium``
is never imported here: the adapter reads the env it is given.
"""

from __future__ import annotations

import abc
import warnings
from typing import Any

import numpy as np


class HostVecEnv(abc.ABC):
    """Stateful vectorized environment running on the host.

    Unlike :class:`~rsl_rl_tpu_torch.env.vec_env.VecEnv`, this API is stateful
    and numpy-based, the upstream reference's ``VecEnv`` contract. Envs reset
    themselves where they are done: the obs returned at a done step is the
    first obs of the fresh episode.
    """

    is_jax = False

    num_envs: int
    num_actions: int
    max_episode_length: int
    cfg: Any = None

    #: Optional per-env elapsed-step counter, as Isaac-style simulators
    #: expose it. When it is not None, ``OnPolicyRunner.learn(
    #: init_at_random_ep_len=True)`` randomizes it: in place when it is a
    #: writable ndarray (a view into the simulator's state sees the write),
    #: otherwise by replacing the attribute, so an env exposing another
    #: buffer type must re-read the attribute each step. An env without the
    #: buffer leaves it None, and the runner warns instead.
    episode_length_buf: np.ndarray | None = None

    @abc.abstractmethod
    def reset(self, seed: int | None = None) -> dict[str, np.ndarray]:
        """Reset all envs; returns the obs-group dict."""

    @abc.abstractmethod
    def step(self, actions: np.ndarray) -> tuple[dict[str, np.ndarray], np.ndarray, np.ndarray, dict]:
        """Step all envs: ``(obs_dict, rewards [N], dones [N], extras)``, with
        the extras of the functional contract (``time_outs``, ``log``)."""


class GymVecEnv(HostVecEnv):
    """Adapter for ``gymnasium.vector`` environments.

    The single observation array becomes the ``"policy"`` obs group, and
    truncations that are not terminations become ``extras["time_outs"]``, so
    PPO bootstraps the value at time limits.
    """

    def __init__(self, env, obs_group: str = "policy", cfg: dict | None = None):
        # Gymnasium >= 1.0 defaults vector envs to NEXT_STEP autoreset: the
        # done step returns the terminal obs and the next step ignores its
        # action to return the reset obs. That breaks the same-step contract
        # (the obs at done starts the fresh episode) and would corrupt every
        # episode-boundary transition, so it is refused.
        mode = getattr(env, "metadata", {}).get("autoreset_mode")
        if mode is not None and getattr(mode, "name", str(mode)) != "SAME_STEP":
            raise ValueError(
                f"GymVecEnv requires same-step autoreset, got {mode}. Construct the"
                " vector env with gym.make_vec(..., vector_kwargs={'autoreset_mode':"
                " gymnasium.vector.AutoresetMode.SAME_STEP})."
            )
        self.env = env
        self.obs_group = obs_group
        self.num_envs = env.num_envs
        self.num_actions = int(np.prod(env.single_action_space.shape))
        spec = getattr(getattr(env, "spec", None), "max_episode_steps", None)
        if spec is None:
            # a wrong horizon silently changes the timeout bootstrap
            warnings.warn(
                "GymVecEnv: the wrapped env's spec declares no max_episode_steps;"
                " falling back to max_episode_length=1000. Pass an env with a"
                " TimeLimit spec or set .max_episode_length explicitly —"
                " init_at_random_ep_len and logging use it.",
                UserWarning,
                stacklevel=2,
            )
        self.max_episode_length = spec or 1000
        self.cfg = cfg or {}

    def _obs(self, obs: np.ndarray) -> dict[str, np.ndarray]:
        return {self.obs_group: np.asarray(obs, np.float32)}

    def reset(self, seed: int | None = None) -> dict[str, np.ndarray]:
        obs, _ = self.env.reset(seed=seed)
        return self._obs(obs)

    def step(self, actions: np.ndarray):
        obs, rew, terminated, truncated, _ = self.env.step(np.asarray(actions))
        terminated, truncated = np.asarray(terminated), np.asarray(truncated)
        extras = {"time_outs": truncated & ~terminated}
        return self._obs(obs), np.asarray(rew, np.float32), terminated | truncated, extras
