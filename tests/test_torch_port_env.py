"""The port's ``NLinkPendulum`` against the JAX env, stepped from identical
states with identical actions.

The physics is deterministic, so every step is compared. The reset draws
differ by construction (threefry against a ``torch.Generator``), so for envs
that time out the test checks the reset itself (range of the fresh state,
zeroed episode length) and then copies the JAX state over before the next
step, so that every step starts from identical states.
"""

import jax
import numpy as np
import torch

from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu_torch.env.nlink import NLinkPendulum, NLinkState

N, L, MAX_LEN, STEPS = 64, 5, 6, 8


def _to_port(state) -> NLinkState:
    return NLinkState(
        episode_length=torch.tensor(np.asarray(state.episode_length)),
        theta=torch.tensor(np.asarray(state.theta)),
        omega=torch.tensor(np.asarray(state.omega)),
    )


def test_step_matches_jax_with_injected_resets():
    jenv = JaxNLink(N, L, max_episode_length=MAX_LEN)
    env = NLinkPendulum(N, L, max_episode_length=MAX_LEN, device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    # inject time-outs: a third of the envs start one step before the limit
    lengths = np.zeros(N, np.int32)
    lengths[::3] = MAX_LEN - 1
    jstate = jstate.replace(episode_length=jax.numpy.asarray(lengths))
    env.reset(0)
    rng = np.random.default_rng(0)
    saw_reset = False
    for step in range(STEPS):
        actions = rng.normal(scale=3.0, size=(N, L)).astype(np.float32)
        state = _to_port(jstate)
        jstate, jobs, jrew, jdone, jextras = jenv.step(jstate, jax.numpy.asarray(actions))
        state, obs, rew, done, extras = env.step(state, torch.tensor(actions))

        jdone = np.asarray(jdone)
        np.testing.assert_array_equal(done.numpy(), jdone, err_msg=f"step {step} dones")
        np.testing.assert_array_equal(extras["time_outs"].numpy(), np.asarray(jextras["time_outs"]))
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {step} reward")
        np.testing.assert_allclose(extras["log"]["nlink/tip_height"].numpy(),
                                   np.asarray(jextras["log"]["nlink/tip_height"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(state.episode_length.numpy(), np.asarray(jstate.episode_length))
        live = ~jdone
        for name, got, want in (("theta", state.theta, jstate.theta), ("omega", state.omega, jstate.omega),
                                ("obs", obs["policy"], jobs["policy"])):
            np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step} {name}")
        if jdone.any():
            saw_reset = True
            assert np.all(np.abs(state.theta.numpy()[jdone]) <= 0.1)
            assert np.all(np.abs(state.omega.numpy()[jdone]) <= 0.05)
            assert np.all(state.episode_length.numpy()[jdone] == 0)
            fresh = state.theta.numpy()[jdone]
            np.testing.assert_allclose(obs["policy"].numpy()[jdone][:, :L], np.cos(fresh), rtol=1e-6)
    assert saw_reset


def test_reset_shapes_and_ranges():
    env = NLinkPendulum(N, L, device="cpu")
    state, obs = env.reset(3)
    assert obs["policy"].shape == (N, 3 * L) and obs["policy"].dtype == torch.float32
    assert state.episode_length.dtype == torch.int32
    assert float(state.theta.abs().max()) <= 0.1 and float(state.omega.abs().max()) <= 0.05
    _, obs2 = NLinkPendulum(N, L, device="cpu").reset(3)
    torch.testing.assert_close(obs["policy"], obs2["policy"], rtol=0, atol=0)
