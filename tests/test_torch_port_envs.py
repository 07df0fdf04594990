"""The port's remaining functional envs (``CartPoleSwingUp``, ``Reacher``,
``Hopper``, ``SparseGoalReach``) against the JAX package's, stepped from
identical states with identical actions for 50 steps, by the method of
``tests/test_torch_port_parity_envs.py``: the reset draws differ by
construction (threefry against the port's per-env splitmix64 keys), so where
an env resets the test checks the fresh state's ranges and zeroed episode
length, and the JAX state is copied over before every step.

Tolerances: rewards, states, obs and logs at rtol 1e-5 / atol 1e-5 (fp32
arithmetic in another order); dones, time-outs and episode lengths exactly.
Then the JAX package's physics cases of ``tests/test_envs.py`` on the
port's envs: the hopper's ballistic flight, its passive drop bouncing and
decaying, its unilateral contact force, and the cart-pole hanging down and
terminal at the track limit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.env import CartPoleSwingUp as JaxCartPole
from rsl_rl_tpu.env import Hopper as JaxHopper
from rsl_rl_tpu.env import Reacher as JaxReacher
from rsl_rl_tpu.env import SparseGoalReach as JaxSparse
from rsl_rl_tpu_torch.env import CartPoleSwingUp, Hopper, Reacher, SparseGoalReach
from rsl_rl_tpu_torch.env.cartpole import CartPoleState
from rsl_rl_tpu_torch.env.hopper import HopperState
from rsl_rl_tpu_torch.env.nlink import env_keys
from rsl_rl_tpu_torch.env.reacher import ReacherState
from rsl_rl_tpu_torch.env.sparse import SparseGoalState
from rsl_rl_tpu_torch.utils.registry import resolve

N, STEPS = 32, 50


def _t(x):
    return torch.tensor(np.asarray(x))


#: name -> (JAX class, port class, kwargs, (action loc, scale), state fields, port state from the JAX state)
ENVS = {
    "cartpole": (JaxCartPole, CartPoleSwingUp, dict(max_episode_length=40), (0.0, 1.5),
                 ("x", "x_dot", "theta", "theta_dot"),
                 lambda st: CartPoleState(episode_length=_t(st.episode_length), x=_t(st.x), x_dot=_t(st.x_dot),
                                          theta=_t(st.theta), theta_dot=_t(st.theta_dot), rng=env_keys(0, N))),
    "reacher": (JaxReacher, Reacher, dict(max_episode_length=7), (0.0, 1.0), ("q", "qd", "target"),
                lambda st: ReacherState(episode_length=_t(st.episode_length), q=_t(st.q), qd=_t(st.qd),
                                        target=_t(st.target), rng=env_keys(0, N))),
    "hopper": (JaxHopper, Hopper, dict(max_episode_length=7), (0.5, 0.5), ("z", "v"),
               lambda st: HopperState(episode_length=_t(st.episode_length), z=_t(st.z), v=_t(st.v),
                                      rng=env_keys(0, N))),
    "sparse": (JaxSparse, SparseGoalReach, dict(max_episode_length=40, goal_dist=0.6, goal_radius=0.4),
               (1.0, 1.0), ("pos", "vel"),
               lambda st: SparseGoalState(episode_length=_t(st.episode_length), pos=_t(st.pos), vel=_t(st.vel),
                                          rng=env_keys(0, N))),
}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=what)


def _check_fresh(name, env, state, obs, done):
    """The reset envs' fresh states lie in the reset distribution's ranges."""
    assert np.all(state.episode_length.numpy()[done] == 0)
    if name == "cartpole":
        assert np.all(np.abs(state.x.numpy()[done]) <= 0.5)
        assert np.all(np.abs(state.theta.numpy()[done] - math.pi) <= 0.1 + 1e-6)
        assert np.all(state.x_dot.numpy()[done] == 0) and np.all(state.theta_dot.numpy()[done] == 0)
    elif name == "reacher":
        assert np.all(np.abs(state.q.numpy()[done]) <= math.pi) and np.all(state.qd.numpy()[done] == 0)
        radius = np.linalg.norm(state.target.numpy()[done], axis=-1)
        assert np.all((radius >= 0.3 - 1e-6) & (radius < 0.9 + 1e-6))
    elif name == "hopper":
        z = state.z.numpy()[done]
        assert np.all((z >= env.l0) & (z < env.l0 + 0.3 + 1e-6)) and np.all(state.v.numpy()[done] == 0)
    else:
        assert np.all(np.abs(state.pos.numpy()[done]) <= 0.5) and np.all(state.vel.numpy()[done] == 0)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_steps_match_jax(name):
    jax_cls, cls, kw, (loc, scale), fields, to_port = ENVS[name]
    jenv, env = jax_cls(N, **kw), cls(N, **kw, device="cpu")
    assert env.num_actions == jenv.num_actions and env.step_dt == jenv.step_dt
    assert resolve("env", cls.__name__) is cls
    jstate, jobs = jenv.reset(jax.random.PRNGKey(0))
    lengths = np.arange(N, dtype=np.int32) % kw["max_episode_length"]  # spread the time-outs
    jstate = jstate.replace(episode_length=jnp.asarray(lengths))
    _, obs = env.reset(0)
    assert obs.keys() == jobs.keys() and all(obs[k].shape == jobs[k].shape for k in obs)
    rng = np.random.default_rng(1)
    resets = terminals = 0
    for step in range(STEPS):
        actions = rng.normal(loc, scale, size=(N, env.num_actions)).astype(np.float32)
        if name == "cartpole":
            actions[: N // 4] = 1.0  # push a quarter of the carts off the track: true terminal states
        state = to_port(jstate)
        jstate, jobs, jrew, jdone, jextras = jenv.step(jstate, jnp.asarray(actions))
        state, obs, rew, done, extras = env.step(state, torch.tensor(actions))

        jdone = np.asarray(jdone)
        np.testing.assert_array_equal(done.numpy(), jdone, err_msg=f"step {step} dones")
        np.testing.assert_array_equal(extras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        _close(rew, jrew, f"step {step} reward")
        assert extras["log"].keys() == jextras["log"].keys()
        for k, v in extras["log"].items():
            _close(v, jextras["log"][k], f"step {step} log {k}")
        np.testing.assert_array_equal(state.episode_length.numpy(), np.asarray(jstate.episode_length))
        live = ~jdone
        for f in fields:
            _close(getattr(state, f).numpy()[live], np.asarray(getattr(jstate, f))[live], f"step {step} {f}")
        for k in obs:
            _close(obs[k].numpy()[live], np.asarray(jobs[k])[live], f"step {step} obs {k}")
        if jdone.any():
            _check_fresh(name, env, state, obs, jdone)
        resets += int(jdone.sum())
        terminals += int((jdone & ~np.asarray(jextras["time_outs"])).sum())
    assert resets > 0
    if name in ("cartpole", "sparse"):
        assert terminals > 0, "want true terminal states beside time-outs"


@pytest.mark.parametrize("cls", [CartPoleSwingUp, Reacher, Hopper, SparseGoalReach])
def test_reset_draws_and_episode_lengths(cls):
    """The fresh states are a function of the seed, random episode lengths
    lie in ``[0, max_episode_length)``, and a per-env limit must cover every
    env."""
    env = cls(64, device="cpu")
    a, _ = env.reset(5)
    b, _ = env.reset(5)
    c, _ = env.reset(6)
    for k in vars(a):
        assert torch.equal(getattr(a, k), getattr(b, k))
    assert not torch.equal(a.rng, c.rng)
    lengths = env.randomize_episode_length(a).episode_length
    assert int(lengths.min()) >= 0 and int(lengths.max()) < env.max_episode_length and lengths.unique().numel() > 4
    per_env = cls(4, max_episode_length=[3, 5, 7, 9], device="cpu")
    state, _ = per_env.reset(0)
    assert torch.all(per_env.randomize_episode_length(state).episode_length < torch.tensor([3, 5, 7, 9]))
    with pytest.raises(ValueError, match="entries"):
        cls(3, max_episode_length=[3, 5, 7, 9], device="cpu").reset(0)


def _hopper_state(env, z, v):
    state, _ = env.reset(0)
    return HopperState(episode_length=state.episode_length, z=torch.tensor(z, dtype=torch.float32),
                       v=torch.tensor(v, dtype=torch.float32), rng=state.rng)


def test_hopper_ballistic_in_flight():
    """Above the leg length there is no contact force: the body follows
    projectile motion (semi-implicit Euler), thrust or not."""
    env = Hopper(2, max_episode_length=1000, device="cpu")
    state2, *_ = env.step(_hopper_state(env, [2.0, 2.0], [1.0, 1.0]), torch.tensor([[1.0], [0.0]]))
    np.testing.assert_allclose(float(state2.z[0]), float(state2.z[1]), rtol=1e-6)
    z, v = 2.0, 1.0
    h = env.dt / env.n_substeps
    for _ in range(env.n_substeps):
        v -= h * env.g
        z += h * v
    np.testing.assert_allclose(float(state2.z[0]), z, rtol=1e-6)


def test_hopper_passive_drop_bounces_and_decays():
    """Dropped with no thrust, the body bounces on the leg spring and the
    successive apexes decay."""
    env = Hopper(1, max_episode_length=100_000, device="cpu")
    state = _hopper_state(env, [1.8], [0.0])
    zs = []
    for _ in range(300):
        state, *_ = env.step(state, torch.zeros(1, 1))
        zs.append(float(state.z[0]))
    zs = np.asarray(zs)
    assert zs.min() < env.l0, "never made contact"
    apexes = [zs[i] for i in range(1, len(zs) - 1)
              if zs[i] > env.l0 and zs[i] >= zs[i - 1] and zs[i] >= zs[i + 1]]
    assert len(apexes) >= 2, "did not rebound into flight"
    assert apexes[1] < apexes[0], apexes[:2]
    assert zs[-1] < 1.2


def test_hopper_contact_force_is_unilateral():
    """The leg pushes but never pulls: moving up just above the rest length,
    the only acceleration is gravity."""
    env = Hopper(1, max_episode_length=100_000, device="cpu")
    state2, *_ = env.step(_hopper_state(env, [env.l0 + 0.01], [3.0]), torch.zeros(1, 1))
    np.testing.assert_allclose(float(state2.v[0]) - 3.0, -env.g * env.dt, rtol=1e-4)


def test_cartpole_starts_hanging_down_and_terminates_at_the_track_limit():
    env = CartPoleSwingUp(8, device="cpu")
    _, obs = env.reset(0)
    assert float(obs["policy"][:, 2].max()) < -0.9  # cos(theta) near -1
    env = CartPoleSwingUp(1, max_episode_length=10_000, device="cpu")
    state, _ = env.reset(0)
    for _ in range(2000):
        state, obs, rew, done, extras = env.step(state, torch.ones(1, 1))
        if bool(done[0]):
            assert not bool(extras["time_outs"][0])  # a true terminal
            break
    else:
        pytest.fail("the cart never left the track")
