"""The port's parity envs (``PartiallyObservableNLink``, ``Pendulum``,
``PartiallyObservablePendulum``, ``PrivilegedPendulum``, ``PointMass``)
against the JAX package's, stepped from identical states with identical
actions for 50 steps.

The dynamics are deterministic, so every step is compared. The reset draws
differ by construction (threefry against the port's per-env splitmix64
keys): where an env resets, the test checks the fresh state's ranges and
zeroed episode length, and then the JAX state is copied over before the
next step, so that every step starts from identical states.

Tolerances: rewards, states and obs at rtol 1e-5 / atol 1e-5 (fp32
arithmetic in another order); dones, time-outs and episode lengths exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.env import PartiallyObservableNLink as JaxPONLink
from rsl_rl_tpu.env import PartiallyObservablePendulum as JaxPOPendulum
from rsl_rl_tpu.env import Pendulum as JaxPendulum
from rsl_rl_tpu.env import PointMass as JaxPointMass
from rsl_rl_tpu.env import PrivilegedPendulum as JaxPrivPendulum
from rsl_rl_tpu.env.toy import point_mass_symmetry as jax_point_mass_symmetry
from rsl_rl_tpu_torch.env import (
    PartiallyObservableNLink,
    PartiallyObservablePendulum,
    Pendulum,
    PointMass,
    PrivilegedPendulum,
)
from rsl_rl_tpu_torch.env.nlink import NLinkState, env_keys
from rsl_rl_tpu_torch.env.pendulum import PendulumState
from rsl_rl_tpu_torch.env.toy import PointMassState, point_mass_symmetry
from rsl_rl_tpu_torch.utils.registry import resolve

N, STEPS = 32, 50

#: name -> (JAX class, port class, constructor kwargs, action scale, port state fields from the JAX state)
ENVS = {
    "po_nlink": (JaxPONLink, PartiallyObservableNLink, dict(num_links=5, max_episode_length=7), 3.0,
                 lambda st: NLinkState(episode_length=_t(st.episode_length), theta=_t(st.theta),
                                       omega=_t(st.omega), rng=env_keys(0, N))),
    "pendulum": (JaxPendulum, Pendulum, dict(max_episode_length=7), 2.5,
                 lambda st: PendulumState(episode_length=_t(st.episode_length), theta=_t(st.theta),
                                          theta_dot=_t(st.theta_dot), rng=env_keys(0, N))),
    "po_pendulum": (JaxPOPendulum, PartiallyObservablePendulum, dict(max_episode_length=7), 2.5,
                    lambda st: PendulumState(episode_length=_t(st.episode_length), theta=_t(st.theta),
                                             theta_dot=_t(st.theta_dot), rng=env_keys(0, N))),
    "privileged_pendulum": (JaxPrivPendulum, PrivilegedPendulum, dict(max_episode_length=7), 2.5,
                            lambda st: PendulumState(episode_length=_t(st.episode_length), theta=_t(st.theta),
                                                     theta_dot=_t(st.theta_dot), rng=env_keys(0, N))),
    "point_mass": (JaxPointMass, PointMass, dict(max_episode_length=40), 1.5,
                   lambda st: PointMassState(episode_length=_t(st.episode_length), x=_t(st.x), v=_t(st.v),
                                             rng=env_keys(0, N))),
}
#: the fields of each env state that the physics carries
FIELDS = {"po_nlink": ("theta", "omega"), "point_mass": ("x", "v")}


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_steps_match_jax(name):
    jax_cls, cls, kw, scale, to_port = ENVS[name]
    jenv, env = jax_cls(N, **kw), cls(N, **kw, device="cpu")
    assert env.num_actions == jenv.num_actions and env.step_dt == jenv.step_dt
    assert resolve("env", cls.__name__) is cls
    jstate, jobs = jenv.reset(jax.random.PRNGKey(0))
    # spread the time-outs over the window
    lengths = np.arange(N, dtype=np.int32) % kw["max_episode_length"]
    jstate = jstate.replace(episode_length=jnp.asarray(lengths))
    _, obs = env.reset(0)
    assert obs.keys() == jobs.keys() and all(obs[k].shape == jobs[k].shape for k in obs)
    fields = FIELDS.get(name, ("theta", "theta_dot"))
    rng = np.random.default_rng(1)
    resets = terminals = 0
    for step in range(STEPS):
        actions = rng.normal(scale=scale, size=(N, env.num_actions)).astype(np.float32)
        if name == "point_mass":
            actions[: N // 2] += 2.0  # half the masses pushed out of bounds: true terminal states
        state = to_port(jstate)
        jstate, jobs, jrew, jdone, jextras = jenv.step(jstate, jnp.asarray(actions))
        state, obs, rew, done, extras = env.step(state, torch.tensor(actions))

        jdone = np.asarray(jdone)
        np.testing.assert_array_equal(done.numpy(), jdone, err_msg=f"step {step} dones")
        np.testing.assert_array_equal(extras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        _close(rew, jrew, f"step {step} reward")
        for k, v in extras["log"].items():
            _close(v, jextras["log"][k], f"step {step} log {k}")
        np.testing.assert_array_equal(state.episode_length.numpy(), np.asarray(jstate.episode_length))
        live = ~jdone
        for f in fields:
            _close(getattr(state, f).numpy()[live], np.asarray(getattr(jstate, f))[live], f"step {step} {f}")
        for k in obs:
            _close(obs[k].numpy()[live], np.asarray(jobs[k])[live], f"step {step} obs {k}")
        resets += int(jdone.sum())
        terminals += int((jdone & ~np.asarray(jextras["time_outs"])).sum())
        if jdone.any():
            assert np.all(state.episode_length.numpy()[jdone] == 0)
            if name == "point_mass":
                assert np.all(np.abs(state.x.numpy()[jdone]) <= 2.0) and np.all(state.v.numpy()[jdone] == 0)
                assert np.all(obs["privileged"].numpy()[jdone][:, 2] == 0)  # no last action on a fresh episode
            elif name == "po_nlink":
                assert np.all(np.abs(state.theta.numpy()[jdone]) <= 0.1)
            else:
                assert np.all(np.abs(state.theta.numpy()[jdone]) <= math.pi)
                assert np.all(np.abs(state.theta_dot.numpy()[jdone]) <= 1.0)
    assert resets > 0
    if name == "point_mass":
        assert terminals > 0, "want true terminal states beside time-outs"


def test_po_pendulum_hides_velocity():
    """The partially observable pendulum observes ``[cos, sin]`` only, the
    privileged one adds the velocity to a second group."""
    state, obs = PartiallyObservablePendulum(16, device="cpu").reset(1)
    assert obs["policy"].shape == (16, 2)
    np.testing.assert_allclose(obs["policy"].numpy(), np.stack([np.cos(state.theta.numpy()), np.sin(state.theta.numpy())], -1),
                               rtol=1e-6)
    state, obs = PrivilegedPendulum(16, device="cpu").reset(1)
    assert obs["policy"].shape == (16, 2) and obs["privileged"].shape == (16, 3)
    np.testing.assert_array_equal(obs["privileged"][:, 2].numpy(), state.theta_dot.numpy())
    _, obs = PartiallyObservableNLink(16, num_links=5, device="cpu").reset(1)
    assert obs["policy"].shape == (16, 10)


@pytest.mark.parametrize("cls", [Pendulum, PointMass, PartiallyObservableNLink])
def test_reset_draws_are_a_function_of_the_seed(cls):
    """The fresh states come from per-env keys of the seed: the same seed
    draws the same state, another seed another, and random episode lengths
    lie in ``[0, max_episode_length)``."""
    env = cls(64, device="cpu")
    a, _ = env.reset(5)
    b, _ = env.reset(5)
    c, _ = env.reset(6)
    for k in vars(a):
        assert torch.equal(getattr(a, k), getattr(b, k))
    assert not torch.equal(a.rng, c.rng)
    lengths = env.randomize_episode_length(a).episode_length
    assert int(lengths.min()) >= 0 and int(lengths.max()) < env.max_episode_length and lengths.unique().numel() > 4


def test_point_mass_symmetry_matches_jax():
    rng = np.random.default_rng(2)
    obs = {"policy": rng.normal(size=(6, 2)).astype(np.float32), "privileged": rng.normal(size=(6, 3)).astype(np.float32)}
    actions = rng.normal(size=(6, 1)).astype(np.float32)
    jo, ja = jax_point_mass_symmetry(obs={k: jnp.asarray(v) for k, v in obs.items()}, actions=jnp.asarray(actions))
    to, ta = point_mass_symmetry(obs={k: _t(v) for k, v in obs.items()}, actions=_t(actions))
    for k in obs:
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert point_mass_symmetry(obs=None, actions=_t(actions))[0] is None
