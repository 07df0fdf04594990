"""The port's MuJoCo host envs (``env/mujoco_host.py``) on the CPU.

- ``MuJoCoNLinkEnv`` equals the JAX package's step for step from the same
  seed: obs, rewards, dones, time-outs and logs exactly (the same numpy and
  MuJoCo code).
- It follows the port's own ``NLinkPendulum`` dynamics from the same state,
  at the tolerances of ``tests/test_mujoco_conformance.py``'s env-step case
  (obs atol 5e-3, rewards rtol / atol 5e-3: fp32 against MuJoCo's fp64 on a
  chaotic system).
- PPO trains on it through the port's ``OnPolicyRunner`` (2 iterations, 16
  envs).
"""

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from rsl_rl_tpu.env.mujoco_host import MuJoCoNLinkEnv as JaxMuJoCoNLinkEnv  # noqa: E402
from rsl_rl_tpu.env.mujoco_host import nlink_mjcf as jax_nlink_mjcf  # noqa: E402
from rsl_rl_tpu_torch.env import HostVecEnv, MuJoCoNLinkEnv, NLinkPendulum  # noqa: E402
from rsl_rl_tpu_torch.env.mujoco_host import nlink_mjcf  # noqa: E402
from rsl_rl_tpu_torch.runners import OnPolicyRunner  # noqa: E402


def test_steps_equal_the_jax_package_env():
    lengths = np.ones(3) / 3
    assert nlink_mjcf(3, lengths, 0.005) == jax_nlink_mjcf(3, lengths, 0.005)
    env = MuJoCoNLinkEnv(num_envs=4, num_links=3, max_episode_length=5, seed=2)
    jenv = JaxMuJoCoNLinkEnv(num_envs=4, num_links=3, max_episode_length=5, seed=2)
    assert isinstance(env, HostVecEnv) and env.is_jax is False
    obs, jobs = env.reset(seed=7), jenv.reset(seed=7)
    np.testing.assert_array_equal(obs["policy"], jobs["policy"])
    rng = np.random.default_rng(0)
    for t in range(12):  # two auto-resets
        actions = rng.uniform(-3.0, 3.0, (4, 3)).astype(np.float32)
        obs, rew, done, extras = env.step(actions)
        jobs, jrew, jdone, jextras = jenv.step(actions)
        np.testing.assert_array_equal(obs["policy"], jobs["policy"], err_msg=f"step {t} obs")
        np.testing.assert_array_equal(rew, jrew)
        np.testing.assert_array_equal(done, jdone)
        np.testing.assert_array_equal(extras["time_outs"], jextras["time_outs"])
        np.testing.assert_array_equal(extras["log"]["nlink/tip_height"], jextras["log"]["nlink/tip_height"])
        np.testing.assert_array_equal(env.episode_length_buf, jenv.episode_length_buf)
    assert (env.episode_length_buf == 2).all()


def test_follows_the_port_nlink_dynamics():
    n, L = 4, 5
    port_env = NLinkPendulum(n, L, max_episode_length=1000, device="cpu")
    host_env = MuJoCoNLinkEnv(num_envs=n, num_links=L, max_episode_length=1000)
    state, obs = port_env.reset(0)
    theta, omega = state.theta.double().numpy(), state.omega.double().numpy()
    for i, d in enumerate(host_env.data):  # start the host env from the port env's state
        d.qpos[:] = np.diff(theta[i], prepend=0.0)
        d.qvel[:] = np.diff(omega[i], prepend=0.0)
        mujoco.mj_forward(host_env.model, d)
    np.testing.assert_allclose(obs["policy"].numpy(), host_env._obs_from(*host_env._state())["policy"], atol=1e-5)
    rng = np.random.default_rng(3)
    for t in range(25):
        actions = rng.uniform(-3.0, 3.0, (n, L)).astype(np.float32)
        state, obs, rew, done, _ = port_env.step(state, torch.tensor(actions))
        h_obs, h_rew, h_done, _ = host_env.step(actions)
        assert not bool(done.any()) and not h_done.any()
        np.testing.assert_allclose(obs["policy"].numpy(), h_obs["policy"], atol=5e-3, err_msg=f"obs at step {t}")
        np.testing.assert_allclose(rew.numpy(), h_rew, rtol=5e-3, atol=5e-3, err_msg=f"reward at step {t}")


def test_ppo_trains_on_mujoco_through_the_runner():
    env = MuJoCoNLinkEnv(num_envs=16, num_links=3, max_episode_length=12)
    cfg = {
        "num_steps_per_env": 16,
        "save_interval": 1000,
        "seed": 1,
        "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
        "policy": {"class_name": "ActorCritic", "actor_hidden_dims": [32, 32], "critic_hidden_dims": [32, 32],
                   "actor_obs_normalization": True, "critic_obs_normalization": True},
        "algorithm": {"class_name": "PPO", "learning_rate": 1e-3, "num_learning_epochs": 2, "num_mini_batches": 2},
    }
    runner = OnPolicyRunner(env, cfg, device="cpu")
    runner.learn(2, init_at_random_ep_len=True)
    metrics = runner.history[-1]["metrics"]
    assert all(np.isfinite(v) for v in metrics.values())
    assert sum(row["metrics"]["ep_count"] for row in runner.history) > 0
    assert "extras/nlink/tip_height" in metrics
