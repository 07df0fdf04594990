"""The port's simulator adapters (``env/mjx_env.py`` ``MJXEnv``,
``env/brax_env.py`` ``BraxVecEnv``) against the JAX package's, each over a
double of its simulator: the JAX doubles below (those of
``tests/test_mjx_env.py``) and their torch twins in
``tests/torch_port_sim_doubles.py``. The JAX adapters' import gates are
lifted with ``monkeypatch``, as ``tests/test_mjx_env.py`` lifts them.

Parity: without reset noise both sides' auto-resets are deterministic, so
40 steps of the same actions give the same obs, rewards and states (rtol
1e-6 / atol 1e-6) and the same dones and time-outs. With noise the draws
differ by construction (threefry against the port's per-env keys), so the
JAX initial state is written into the port's and the two agree up to each
env's first done. Then the contract tests of ``tests/test_mjx_env.py`` on
the port, and PPO through the runners on the CPU.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

import rsl_rl_tpu.env.brax_env as jax_brax_mod
import rsl_rl_tpu.env.mjx_env as jax_mjx_mod
from rsl_rl_tpu_torch.env import BraxVecEnv, MJXEnv
from rsl_rl_tpu_torch.env.nlink import env_keys
from rsl_rl_tpu_torch.runners import MultiSeedRunner, OnPolicyRunner
from tests.torch_port_sim_doubles import BraxChain, mj_model, mjx

N, DOF, LIMIT, STEPS, SEED = 8, 3, 16, 40, 3
THRESHOLD = 0.02  # done_fn: qpos[0] past it
BOUND = 0.15  # the Brax double's terminal |x|
TOL = {"rtol": 1e-6, "atol": 1e-6}


# ---- the JAX doubles (tests/test_mjx_env.py's, for DOF degrees of freedom)
@struct.dataclass
class _JaxData:
    qpos: object
    qvel: object
    ctrl: object


def _jax_mjx():
    mod = types.SimpleNamespace()
    mod.put_model = lambda m: m
    mod.make_data = lambda model: _JaxData(qpos=jnp.zeros((model.nq,)), qvel=jnp.zeros((model.nv,)),
                                           ctrl=jnp.zeros((model.nu,)))
    mod.forward = lambda model, data: data

    def step(model, data):
        dt = model.opt.timestep
        qvel = data.qvel + dt * (data.ctrl - 0.1 * data.qvel)
        return data.replace(qpos=data.qpos + dt * qvel, qvel=qvel)

    mod.step = step
    return mod


@struct.dataclass
class _JaxBraxState:
    pipeline: object
    obs: object
    reward: object
    done: object
    metrics: dict = struct.field(pytree_node=True, default_factory=dict)


class _JaxBraxChain:
    """The JAX twin of ``BraxChain`` (x drawn with threefry)."""

    dt = 0.05

    def __init__(self, size=1, bound=0.5, reset_scale=0.1):
        self.action_size, self.bound, self.reset_scale = size, bound, reset_scale

    def _state(self, x, v, reward, done):
        return _JaxBraxState(pipeline={"x": x, "v": v}, obs=jnp.concatenate([x, v]), reward=reward, done=done,
                             metrics={"max_abs_x": jnp.abs(x).max()})

    def reset(self, key):
        zero = jnp.zeros((self.action_size,))
        x = (jax.random.uniform(key, (self.action_size,), minval=-self.reset_scale, maxval=self.reset_scale)
             if self.reset_scale else zero)
        return self._state(x, zero, zero.sum(), zero.sum())

    def step(self, state, action):
        v = state.pipeline["v"] + self.dt * action
        x = state.pipeline["x"] + self.dt * v
        done = jnp.any(jnp.abs(x) > self.bound).astype(jnp.float32)
        return self._state(x, v, -jnp.sum(x * x), done)


@pytest.fixture
def jax_gates(monkeypatch):
    monkeypatch.setattr(jax_mjx_mod, "mjx", _jax_mjx())
    monkeypatch.setattr(jax_mjx_mod, "_HAS_MJX", True)
    monkeypatch.setattr(jax_brax_mod, "_HAS_BRAX", True)


# ---- the callables, one per framework
def _callables(xp):
    cat = jnp.concatenate if xp is jnp else torch.cat
    return dict(
        obs_fn=lambda mx, d: {"policy": cat([d.qpos, d.qvel])},
        reward_fn=lambda mx, d, a: -xp.sum(d.qpos * d.qpos) - 0.01 * xp.sum(a * a),
        done_fn=lambda mx, d: d.qpos[0] > THRESHOLD,
    )


def _port_mjx(noise=0.0, num_envs=N, limit=LIMIT):
    return MJXEnv(mj_model(DOF, DOF, DOF), num_envs=num_envs, episode_length=limit, reset_noise_scale=noise,
                  action_scale=2.0, **_callables(torch), sim=mjx, device="cpu")


def _port_brax(reset_scale=0.0, num_envs=N, limit=LIMIT):
    return BraxVecEnv(BraxChain(DOF, bound=BOUND, reset_scale=reset_scale), num_envs, limit, device="cpu")


def _pair(kind, noise):
    """The JAX adapter and the port's over twin doubles (needs ``jax_gates``)."""
    if kind == "mjx":
        jax_env = jax_mjx_mod.MJXEnv(mj_model(DOF, DOF, DOF), num_envs=N, episode_length=LIMIT,
                                     reset_noise_scale=noise, action_scale=2.0, **_callables(jnp))
        env = _port_mjx(noise)
    else:
        jax_env = jax_brax_mod.BraxVecEnv(_JaxBraxChain(DOF, bound=BOUND, reset_scale=noise), N, LIMIT)
        env = _port_brax(noise)
    jax_env.kind = env.kind = kind
    return jax_env, env


def _actions(steps=STEPS, n=N):
    return np.random.default_rng(0).uniform(-1.0, 1.2, (steps, n, DOF)).astype(np.float32)


def _states(kind, state):
    """The sim state's arrays by name, numpy."""
    if kind == "mjx":
        return {k: np.asarray(getattr(state.data, k)) for k in ("qpos", "qvel", "ctrl")}
    return {k: np.asarray(state.brax.pipeline[k]) for k in ("x", "v")}


def _run(env, state, actions, jax_side):
    step = jax.jit(env.step) if jax_side else env.step
    out = []
    for a in actions:
        state, obs, rew, done, extras = step(state, jnp.asarray(a) if jax_side else torch.from_numpy(a))
        out.append({"obs": np.asarray(obs["policy"]), "rew": np.asarray(rew), "done": np.asarray(done),
                    "time_outs": np.asarray(extras["time_outs"]), "state": _states(env.kind, state),
                    "log": {k: np.asarray(v) for k, v in extras.get("log", {}).items()},
                    "episode_length": np.asarray(state.episode_length)})
    return out


@pytest.mark.parametrize("kind", ["mjx", "brax"])
def test_adapters_match_jax_without_reset_noise(jax_gates, kind):
    jax_env, env = _pair(kind, 0.0)
    jax_state, jax_obs = jax_env.reset(jax.random.PRNGKey(SEED))
    state, obs = env.reset(SEED)
    np.testing.assert_allclose(obs["policy"].numpy(), np.asarray(jax_obs["policy"]), **TOL)
    actions = _actions()
    want, got = _run(jax_env, jax_state, actions, True), _run(env, state, actions, False)
    for t, (w, g) in enumerate(zip(want, got)):
        for k in ("done", "time_outs", "episode_length"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} at step {t}")
        for k in ("obs", "rew"):
            np.testing.assert_allclose(g[k], w[k], **TOL, err_msg=f"{k} at step {t}")
        for k in w["state"]:
            np.testing.assert_allclose(g["state"][k], w["state"][k], **TOL, err_msg=f"{k} at step {t}")
        assert g["log"].keys() == w["log"].keys()
        for k in w["log"]:
            np.testing.assert_allclose(g["log"][k], w["log"][k], **TOL)
    dones = np.stack([w["done"] for w in want])
    time_outs = np.stack([w["time_outs"] for w in want])
    assert time_outs.any() and (dones & ~time_outs).any(), "the run should see time-outs and terminals"


def _inject(kind, state, jax_state):
    """The port's state with the JAX initial state's sim arrays."""
    if kind == "mjx":
        data = dataclasses.replace(state.data, **{k: torch.from_numpy(np.array(getattr(jax_state.data, k)))
                                                  for k in ("qpos", "qvel", "ctrl")})
        return dataclasses.replace(state, data=data)
    jb = jax_state.brax
    brax = dataclasses.replace(state.brax, pipeline={k: torch.from_numpy(np.array(v)) for k, v in jb.pipeline.items()},
                               obs=torch.from_numpy(np.array(jb.obs)))
    return dataclasses.replace(state, brax=brax)


@pytest.mark.parametrize("kind", ["mjx", "brax"])
def test_adapters_match_jax_from_its_noisy_reset_until_each_first_done(jax_gates, kind):
    jax_env, env = _pair(kind, 0.01 if kind == "mjx" else 0.02)
    jax_state, _ = jax_env.reset(jax.random.PRNGKey(SEED))
    state, _ = env.reset(SEED)
    state = _inject(kind, state, jax_state)
    actions = _actions()
    want, got = _run(jax_env, jax_state, actions, True), _run(env, state, actions, False)
    live = np.ones(N, bool)
    for t, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g["done"][live], w["done"][live], err_msg=f"step {t}")
        np.testing.assert_allclose(g["rew"][live], w["rew"][live], **TOL, err_msg=f"reward at step {t}")
        live &= ~w["done"]  # a done env's obs is its fresh episode's, drawn differently
        np.testing.assert_allclose(g["obs"][live], w["obs"][live], **TOL, err_msg=f"obs at step {t}")
    assert not live.any(), "every env finishes an episode"


def test_mjx_reset_draws_are_in_range_distinct_and_not_the_carried_keys():
    scale = 0.01
    env = _port_mjx(scale, num_envs=64)
    state, _ = env.reset(SEED)
    draws = torch.cat([state.data.qpos, state.data.qvel], dim=1)  # make_data's state is zero
    assert bool((draws >= -scale).all()) and bool((draws < scale).all())
    assert len(set(draws[:, 0].tolist())) == 64
    # the carried keys are not those the initial draws consumed, and the
    # first auto-reset draws anew (TestMJXRngStreams)
    assert not torch.equal(state.rng, env_keys(SEED, 64))
    assert len(set(state.rng.tolist())) == 64
    state = dataclasses.replace(state, episode_length=torch.full_like(state.episode_length, LIMIT - 1))
    after, _, _, done, _ = env.step(state, torch.zeros(64, DOF))
    assert bool(done.all())
    assert not torch.equal(after.data.qpos, state.data.qpos)
    assert not bool((after.data.qpos == state.data.qpos).any())


@pytest.mark.parametrize("kind", ["mjx", "brax"])
def test_a_shards_keys_and_state_are_the_whole_envs_slice(kind):
    env = _port_mjx(0.01) if kind == "mjx" else _port_brax(0.1)
    whole, whole_obs = env.reset(SEED)
    part, part_obs = env.reset(SEED, num_envs=N // 2, env_offset=N // 2)
    assert torch.equal(part.rng, whole.rng[N // 2:])
    assert torch.equal(part_obs["policy"], whole_obs["policy"][N // 2:])


# ---- the contract tests of tests/test_mjx_env.py, on the port
def _mjx_env(num_envs=4, episode_length=8, done_fn=None):
    return MJXEnv(mj_model(), num_envs=num_envs, episode_length=episode_length,
                  obs_fn=lambda mx, d: {"policy": torch.cat([d.qpos, d.qvel])},
                  reward_fn=lambda mx, d, a: -torch.square(d.qpos[0]), done_fn=done_fn, reset_noise_scale=0.01,
                  sim=mjx, device="cpu")


def test_mjx_contract_shapes_and_types():
    env = _mjx_env()
    assert env.num_actions == 1 and env.step_dt == pytest.approx(0.02)
    state, obs = env.reset(0)
    assert obs["policy"].shape == (4, 2)
    assert len(set(state.data.qpos[:, 0].tolist())) == 4
    state, obs, rew, done, extras = env.step(state, torch.ones(4, 1))
    assert rew.shape == (4,) and rew.dtype == torch.float32
    assert done.shape == (4,) and done.dtype == torch.bool and "time_outs" in extras
    assert state.episode_length.dtype == torch.int32 and state.rng.dtype == torch.int64


def test_mjx_timeout_autoreset():
    env = _mjx_env()
    state, _ = env.reset(0)
    for _ in range(8):
        state, obs, rew, done, extras = env.step(state, torch.ones(4, 1))
    assert bool(done.all()) and bool(extras["time_outs"].all())
    assert int(state.episode_length.sum()) == 0
    assert float(state.data.qpos.abs().max()) < 0.02


def test_mjx_terminal_vs_timeout_split():
    env = _mjx_env(episode_length=1000, done_fn=lambda mx, d: d.qpos[0] > 0.001)
    state, _ = env.reset(1)
    done_any = False
    for _ in range(20):
        state, obs, rew, done, extras = env.step(state, torch.ones(4, 1))
        assert not bool((extras["time_outs"] & done).any())
        done_any = done_any or bool(done.any())
    assert done_any, "done_fn never triggered"


def test_mjx_without_sim_raises():
    with pytest.raises(ImportError, match="no torch package provides"):
        MJXEnv(mj_model(), num_envs=4, episode_length=10, obs_fn=None, reward_fn=None)


def test_adapters_built_for_cuda_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MJXEnv(mj_model(), num_envs=4, episode_length=10, obs_fn=None, reward_fn=None, sim=mjx)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BraxVecEnv(BraxChain(), num_envs=4, episode_length=10)


def _brax_env(num_envs=4, episode_length=8):
    return BraxVecEnv(BraxChain(), num_envs=num_envs, episode_length=episode_length, device="cpu")


def test_brax_contract_and_metrics_log():
    env = _brax_env()
    assert env.num_actions == 1 and env.step_dt == pytest.approx(0.05)
    state, obs = env.reset(0)
    assert obs["policy"].shape == (4, 2)
    state, obs, rew, done, extras = env.step(state, torch.zeros(4, 1))
    assert rew.shape == (4,) and rew.dtype == torch.float32 and done.dtype == torch.bool
    assert extras["log"]["max_abs_x"].shape == (4,)


def test_brax_terminal_autoreset():
    env = _brax_env(episode_length=1000)
    state, _ = env.reset(0)
    for _ in range(35):
        state, obs, rew, done, extras = env.step(state, torch.ones(4, 1))
    assert bool((state.episode_length < 35).all())
    assert not bool(extras["time_outs"].any())
    assert float(state.brax.pipeline["x"].abs().max()) < 0.6


def test_brax_timeout_flagged():
    env = _brax_env(episode_length=3)
    state, _ = env.reset(0)
    for _ in range(3):
        state, obs, rew, done, extras = env.step(state, torch.zeros(4, 1))
    assert bool(done.all()) and bool(extras["time_outs"].all())


# ---- training through the runners on the CPU
FF_CFG = {
    "num_steps_per_env": 8, "save_interval": 1000, "seed": 1,
    "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
    "policy": {"class_name": "ActorCritic", "actor_hidden_dims": [32], "critic_hidden_dims": [32]},
    "algorithm": {"class_name": "PPO"},
}
GRU_CFG = {
    "num_steps_per_env": 8, "seed": 2,
    "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
    "policy": {"class_name": "ActorCriticRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 16,
               "actor_hidden_dims": [16], "critic_hidden_dims": [16], "actor_obs_normalization": True},
    "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2},
}


def test_ppo_learns_on_the_mjx_double():
    runner = OnPolicyRunner(_mjx_env(num_envs=8, episode_length=16), FF_CFG, device="cpu")
    runner.learn(3)
    assert np.isfinite(float(runner.alg.lr))
    assert all(np.isfinite(v).all() for row in runner.history for v in row["metrics"].values())


@pytest.mark.parametrize("kind", ["mjx", "brax"])
def test_gru_policy_trains_through_both_runners(kind):
    def make(n):
        return _port_mjx(0.01, num_envs=n) if kind == "mjx" else _port_brax(0.1, num_envs=n)

    runner = OnPolicyRunner(make(8), GRU_CFG, device="cpu")
    runner.learn(2, init_at_random_ep_len=True)
    study = MultiSeedRunner(make(4), GRU_CFG, 2, device="cpu")
    study.learn(2)
    for r in (runner, study):
        assert all(np.isfinite(v).all() for row in r.history for v in row["metrics"].values())
    if kind == "brax":  # the env's metrics reach the iteration's scalars (Episode/max_abs_x)
        assert "extras/max_abs_x" in runner.history[-1]["metrics"]
