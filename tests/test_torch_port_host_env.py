"""The port's host-env path against the JAX package's.

- The ``HostVecEnv`` contract and ``GymVecEnv``: the cases of
  ``tests/test_host_env.py`` on the port's classes.
- One host collection window (``PPO.make_host_collect_fn``), feedforward and
  GRU, on two ``GymVecEnv`` Pendulum-v1 instances reset from the same seed,
  the JAX policy carried across with ``from_jax_state`` and the JAX action
  noise redrawn from its key chain: obs, actions, values, log-probs, rewards
  (with the time-out bootstrap), the episode metrics, the carries and the
  normalizer at rtol 3e-4 / atol 3e-5 (the update bar), dones exactly; then
  one PPO update of each side's own window (the JAX permutation injected for
  the feedforward policy) at the same bar.
- ``Distillation.make_host_collect_fn`` on a host double with a privileged
  obs group, feedforward and GRU, the same way.
- The runners: a host env without a ``device`` attribute trains on the CPU;
  ``fuse_iteration`` resolves to False; ``iterations_per_dispatch > 1``,
  ``eval_interval`` and ``MultiSeedRunner`` are refused.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from rsl_rl_tpu.algorithms.distillation import Distillation as JaxDistillation  # noqa: E402
from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO  # noqa: E402
from rsl_rl_tpu.env import GymVecEnv as JaxGymVecEnv  # noqa: E402
from rsl_rl_tpu.modules import ActorCritic as JaxAC  # noqa: E402
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR  # noqa: E402
from rsl_rl_tpu.modules import StudentTeacher as JaxST  # noqa: E402
from rsl_rl_tpu.modules import StudentTeacherRecurrent as JaxSTR  # noqa: E402
from rsl_rl_tpu_torch.algorithms.distillation import Distillation  # noqa: E402
from rsl_rl_tpu_torch.algorithms.ppo import PPO  # noqa: E402
from rsl_rl_tpu_torch.env import GymVecEnv, HostVecEnv  # noqa: E402
from rsl_rl_tpu_torch.modules import (  # noqa: E402
    ActorCritic,
    ActorCriticRecurrent,
    StudentTeacher,
    StudentTeacherRecurrent,
)
from rsl_rl_tpu_torch.runners import DistillationRunner, MultiSeedRunner, OnPolicyRunner  # noqa: E402
from rsl_rl_tpu_torch.utils import trace  # noqa: E402
from rsl_rl_tpu_torch.utils.weights import from_jax_state  # noqa: E402

N, T = 16, 16
RTOL, ATOL = 3e-4, 3e-5
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
POLICIES = {
    "feedforward": dict(actor_hidden_dims=[32, 32], critic_hidden_dims=[32, 32], actor_obs_normalization=True,
                        critic_obs_normalization=True),
    "gru": dict(actor_hidden_dims=[16], critic_hidden_dims=[16], rnn_type="gru", rnn_hidden_dim=16,
                actor_obs_normalization=True, critic_obs_normalization=True),
}
PPO_KW = dict(num_learning_epochs=2, num_mini_batches=4)


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _close_tree(got, want, what):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{what}[{i}]")


def _norm_np(norm):
    return {k: None if v is None else {f: np.asarray(getattr(v, f)) for f in ("mean", "var", "count")}
            for k, v in norm.items()}


def _make_vec(num_envs=N, **kw):
    from gymnasium.vector import AutoresetMode

    return gym.make_vec("Pendulum-v1", num_envs=num_envs, vectorization_mode="sync",
                        vector_kwargs={"autoreset_mode": AutoresetMode.SAME_STEP}, **kw)


def _cfg(**overrides):
    cfg = {
        "num_steps_per_env": T,
        "save_interval": 1000,
        "seed": 1,
        "obs_groups": dict(GROUPS),
        "policy": {"class_name": "ActorCritic", **POLICIES["feedforward"]},
        "algorithm": {"class_name": "PPO", "learning_rate": 1e-3, **PPO_KW},
    }
    cfg.update(overrides)
    return cfg


@pytest.fixture
def pendulum_env():
    raw = _make_vec()
    yield GymVecEnv(raw)
    raw.close()


# ------------------------------------------------------- the env contract


def test_gym_contract(pendulum_env):
    obs = pendulum_env.reset(seed=0)
    assert obs["policy"].shape == (N, 3) and obs["policy"].dtype == np.float32
    assert pendulum_env.num_actions == 1 and pendulum_env.max_episode_length == 200
    assert pendulum_env.is_jax is False and isinstance(pendulum_env, HostVecEnv)
    obs, rew, dones, extras = pendulum_env.step(np.zeros((N, 1), np.float32))
    assert rew.shape == (N,) and rew.dtype == np.float32 and "time_outs" in extras


def test_truncation_maps_to_time_outs():
    raw = _make_vec(2)
    env = GymVecEnv(raw)
    env.reset(seed=0)
    for _ in range(200):  # Pendulum-v1 truncates at 200 steps
        _, _, dones, extras = env.step(np.zeros((2, 1), np.float32))
    assert dones.all() and extras["time_outs"].all()
    raw.close()


def test_next_step_autoreset_rejected():
    raw = gym.make_vec("Pendulum-v1", num_envs=2, vectorization_mode="sync")
    try:
        with pytest.raises(ValueError, match="same-step autoreset"):
            GymVecEnv(raw)
    finally:
        raw.close()


def test_same_step_autoreset_gives_fresh_obs_at_done():
    """At a done step the obs already belongs to the new episode: it matches
    the underlying envs' post-reset state."""
    raw = _make_vec(2)
    env = GymVecEnv(raw)
    env.reset(seed=0)
    for _ in range(250):
        obs, _, done, _ = env.step(np.zeros((2, 1), np.float32))
        if done.any():
            break
    assert done.any()
    for i in np.flatnonzero(done):
        theta, theta_dot = raw.unwrapped.envs[i].unwrapped.state
        np.testing.assert_allclose(obs["policy"][i], np.array([np.cos(theta), np.sin(theta), theta_dot], np.float32),
                                   rtol=1e-5, atol=1e-6)
    raw.close()


class CountingHostEnv(HostVecEnv):
    """An Isaac-style host env with a writable ``episode_length_buf`` that its
    step reads, and no ``device`` attribute."""

    def __init__(self, num_envs=8, max_episode_length=50):
        self.num_envs, self.num_actions, self.max_episode_length = num_envs, 1, max_episode_length
        self.episode_length_buf = np.zeros(num_envs, np.int32)

    def reset(self, seed=None):
        self.episode_length_buf[:] = 0
        return {"policy": np.zeros((self.num_envs, 3), np.float32)}

    def step(self, actions):
        self.episode_length_buf += 1
        dones = self.episode_length_buf >= self.max_episode_length
        self.episode_length_buf[dones] = 0
        obs = {"policy": np.tile(self.episode_length_buf[:, None] / self.max_episode_length, (1, 3)).astype(np.float32)}
        return obs, -np.abs(actions[:, 0]).astype(np.float32), dones, {"time_outs": dones}


def test_randomizes_the_buffer_in_place():
    """``learn(init_at_random_ep_len=True)`` scatters the env's buffer over
    ``[0, max_episode_length)``, writing into the same ndarray."""
    env = CountingHostEnv(num_envs=64)
    buf = env.episode_length_buf
    runner = OnPolicyRunner(env, _cfg(num_steps_per_env=4), device="cpu")
    runner.learn(1, init_at_random_ep_len=True)
    assert env.episode_length_buf is buf and buf.dtype == np.int32
    assert len(np.unique(buf)) > 8 and buf.min() >= 0 and buf.max() < env.max_episode_length


class ReadOnlyBufferEnv(CountingHostEnv):
    """Exposes its buffer read-only and re-reads the attribute each step."""

    def reset(self, seed=None):
        self.episode_length_buf = np.zeros(self.num_envs, np.int32)
        self.episode_length_buf.flags.writeable = False
        return {"policy": np.zeros((self.num_envs, 3), np.float32)}

    def step(self, actions):
        lengths = self.episode_length_buf + 1
        dones = lengths >= self.max_episode_length
        self.episode_length_buf = np.where(dones, 0, lengths).astype(np.int32)
        self.episode_length_buf.flags.writeable = False
        return {"policy": np.zeros((self.num_envs, 3), np.float32)}, np.zeros(self.num_envs, np.float32), dones, {}


def test_replaces_a_read_only_buffer():
    """A buffer that cannot be written is replaced by the randomized one."""
    env = ReadOnlyBufferEnv(num_envs=64)
    runner = OnPolicyRunner(env, _cfg(num_steps_per_env=4), device="cpu")
    before = env.episode_length_buf
    runner.learn(1, init_at_random_ep_len=True)
    assert env.episode_length_buf is not before and len(np.unique(env.episode_length_buf)) > 8


def test_warns_without_buffer(pendulum_env):
    runner = OnPolicyRunner(pendulum_env, _cfg(num_steps_per_env=4), device="cpu")
    with pytest.warns(UserWarning, match="episode_length_buf"):
        runner.learn(1, init_at_random_ep_len=True)


# ------------------------------------------------------ PPO host collection


def _jax_host_setup(name):
    """The JAX side on its own GymVecEnv, reset from seed 1: the PPO, its
    train state and collect state."""
    jenv = JaxGymVecEnv(_make_vec(max_episode_steps=10))
    obs = {k: jnp.asarray(v) for k, v in jenv.reset(seed=1).items()}
    cls = JaxAC if name == "feedforward" else JaxACR
    jppo = JaxPPO(cls(obs, GROUPS, 1, **POLICIES[name]), **PPO_KW)
    ts = jppo.init_train_state(jax.random.PRNGKey(1), N)
    return jenv, jppo, ts, jppo.init_collect_state_from((), obs, N)


def _jax_noise(key, shape):
    """The JAX host loop's action noise: one split of the train state's key
    a step."""
    noise = []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k_act, shape)))
    return _t(np.stack(noise))


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_host_window_and_update_match_jax(name):
    jenv, jppo, ts0, cs0 = _jax_host_setup(name)
    ts1, cs1, rollout, cm = jppo.make_host_collect_fn(jenv, T)(ts0, cs0)
    dones = np.asarray(rollout.dones)
    assert dones.any() and float(cm["ep_count"]) == N  # every env timed out at step 10

    raw = _make_vec(max_episode_steps=10)
    env = GymVecEnv(raw)
    obs = {k: _t(v) for k, v in env.reset(seed=1).items()}
    cls = ActorCritic if name == "feedforward" else ActorCriticRecurrent
    policy = cls(obs, GROUPS, 1, device="cpu", **POLICIES[name])
    from_jax_state(jax.device_get(ts0.policy.params), _norm_np(ts0.policy.norm), policy)
    ppo = PPO(policy, **PPO_KW)
    cs = ppo.init_collect_state((), obs, N)
    collect = ppo.make_host_collect_fn(env, T)
    # the window's phases go to the tracer's record of the running iteration
    record = trace.open_iteration(0)
    trace.begin_iteration("cpu")
    cs, got, metrics = collect(cs, action_noise=_jax_noise(ts0.rng, (N, 1)))
    trace.end_collection()
    trace.end_iteration()
    stamps = trace.take_stamps()
    trace.book(record, stamps.labels, stamps.read(), stamps.clock)
    trace.focus(None)

    phases = {"act", "to_host", "env_step", "to_device", "process"}
    assert phases <= set(record.spans)
    assert all(record.spans[k].parent == "collect" and record.spans[k].count == T for k in phases)
    for what in ("actions", "values", "log_probs", "mu", "sigma", "rewards"):
        _close(getattr(got, what), getattr(rollout, what), what)
    _close(got.obs["policy"], rollout.obs["policy"], "obs")
    np.testing.assert_array_equal(got.dones.numpy(), dones)
    assert set(metrics) == set(cm)
    for k in cm:
        _close(metrics[k], cm[k], f"metric {k}")
    _close_tree(cs.carry, cs1.carry, "final carry")
    _close(cs.obs["policy"], cs1.obs["policy"], "final obs")
    for f in ("cur_reward_sum", "cur_episode_length", "cur_ereward_sum", "cur_ireward_sum"):
        _close(getattr(cs.stats, f), getattr(cs1.stats, f), f"episode stats {f}")
    for role in ("actor", "critic"):
        for k in ("mean", "var", "count"):
            _close(getattr(getattr(policy, f"norm_{role}"), k), getattr(ts1.policy.norm[role], k), f"norm {role} {k}")

    # one update of each side's own window
    ts2, _, um = jax.jit(jppo.make_update_fn())(ts1, cs1, rollout)
    perm = None
    if name == "feedforward":  # the permutation the JAX update draws from its key
        perm = _t(jax.random.permutation(jax.random.split(ts1.rng)[1], T * N))
    _, um_port = ppo.update(cs, got, perm=perm)
    um = jax.device_get(um)
    assert set(um_port) == set(um)
    for k in um:
        _close(um_port[k], um[k], f"update metric {k}")
    want = cls(obs, GROUPS, 1, device="cpu", **POLICIES[name])
    from_jax_state(jax.device_get(ts2.policy.params), _norm_np(ts2.policy.norm), want)
    for (pname, got_p), (_, want_p) in zip(policy.named_parameters(), want.named_parameters()):
        _close(got_p, want_p.detach(), f"updated {pname}")
    raw.close()
    jenv.env.close()


def test_host_collect_refuses_a_bridge(pendulum_env):
    """The host collection takes a ``HostShardingBridge`` (host data
    parallelism, ported since): on the one-rank mesh of a process with no
    process group the bridged window and its update equal the unbridged
    ones, and the unbridged collection is unchanged by the bridge's
    existence (the same draws, bit for bit, as a fresh unbridged run)."""
    from rsl_rl_tpu_torch.parallel import HostShardingBridge, make_mesh

    runs = {}
    for mode in ("plain", "bridged", "plain_again"):
        raw = _make_vec()
        env = GymVecEnv(raw)
        obs = {k: _t(v) for k, v in env.reset(seed=0).items()}
        ppo = PPO(ActorCritic(obs, GROUPS, 1, device="cpu", seed=3, **POLICIES["feedforward"]), seed=4, **PPO_KW)
        bridge = HostShardingBridge(make_mesh()) if mode == "bridged" else None
        collect = ppo.make_host_collect_fn(env, T, bridge=bridge)
        assert ppo.mesh is (None if bridge is None else bridge.mesh)
        cs, rollout, metrics = collect(ppo.init_collect_state((), obs, N))
        _, um = ppo.update(cs, rollout)
        runs[mode] = (rollout, metrics, um, [p.detach().clone() for p in ppo.policy.parameters()])
        raw.close()
    plain, bridged, again = runs["plain"], runs["bridged"], runs["plain_again"]
    for field in ("actions", "rewards", "values", "log_probs"):
        torch.testing.assert_close(getattr(again[0], field), getattr(plain[0], field), rtol=0, atol=0)
        _close(getattr(bridged[0], field), getattr(plain[0], field), f"bridged {field}", 1e-5, 1e-6)
    assert set(bridged[1]) == set(plain[1]) and set(bridged[2]) == set(plain[2])
    for k in plain[1]:
        _close(bridged[1][k], plain[1][k], f"bridged metric {k}", 1e-5, 1e-6)
    for k in plain[2]:
        _close(bridged[2][k], plain[2][k], f"bridged update metric {k}", 1e-5, 1e-6)
    for got, want in zip(bridged[3], plain[3]):
        _close(got, want, "bridged parameters", 1e-5, 1e-6)


# ---------------------------------------------- Distillation host collection


class PrivilegedHostDouble(HostVecEnv):
    """A deterministic 2-D point mass on the host: ``"policy"`` sees the
    position, ``"privileged"`` also the velocity; resets depend only on the
    env index and episode count, and every ``max_episode_length`` steps is a
    time-out. It logs its mean speed at each episode end."""

    def __init__(self, num_envs=N, max_episode_length=6):
        self.num_envs, self.num_actions, self.max_episode_length = num_envs, 2, max_episode_length

    def _start(self, ids, ep):
        phi = ((ids * 2654435761 + ep * 40503) % 1000) / 1000.0 * 2.0 * np.pi
        return np.stack([np.cos(phi), np.sin(phi)], axis=-1).astype(np.float32)

    def _obs(self):
        return {"policy": self.x.copy(), "privileged": np.concatenate([self.x, self.v], -1)}

    def reset(self, seed=None):
        self.ids, self.ep = np.arange(self.num_envs), np.zeros(self.num_envs, np.int64)
        self.t = np.zeros(self.num_envs, np.int64)
        self.x, self.v = self._start(self.ids, self.ep), np.zeros((self.num_envs, 2), np.float32)
        return self._obs()

    def step(self, actions):
        a = np.clip(np.asarray(actions, np.float32), -1.0, 1.0)
        self.v = 0.9 * self.v + 0.1 * a
        self.x = self.x + 0.1 * self.v
        rew = -(self.x**2).sum(-1)
        self.t += 1
        done = self.t >= self.max_episode_length
        extras = {"time_outs": done.copy()}
        if done.any():
            extras["episode"] = {"speed": np.abs(self.v[done]).sum(-1)}
            self.ep[done] += 1
            self.t[done] = 0
            self.x[done], self.v[done] = self._start(self.ids[done], self.ep[done]), 0.0
        return self._obs(), rew.astype(np.float32), done, extras


ST_GROUPS = {"policy": ["policy"], "teacher": ["privileged"]}
STUDENTS = {
    "feedforward": dict(student_hidden_dims=[16], teacher_hidden_dims=[16], student_obs_normalization=True),
    "gru": dict(student_hidden_dims=[16], teacher_hidden_dims=[16], rnn_type="gru", rnn_hidden_dim=8,
                student_obs_normalization=True),
}


@pytest.mark.parametrize("name", sorted(STUDENTS))
def test_distillation_host_window_matches_jax(name):
    """The student's sampled actions, the teacher's recorded actions, obs of
    both groups, rewards, dones, the episode and extras metrics, the carry
    and the student's normalizer."""
    jenv = PrivilegedHostDouble()
    obs = {k: jnp.asarray(v) for k, v in jenv.reset(seed=0).items()}
    jcls, cls = (JaxST, StudentTeacher) if name == "feedforward" else (JaxSTR, StudentTeacherRecurrent)
    jalg = JaxDistillation(jcls(obs, ST_GROUPS, 2, **STUDENTS[name]))
    ts0 = jalg.init_train_state(jax.random.PRNGKey(1), N)
    cs0 = jalg.init_collect_state_from((), obs, N)
    ts1, cs1, rollout, cm = jalg.make_host_collect_fn(jenv, T)(ts0, cs0)
    assert np.asarray(rollout.dones).any()

    env = PrivilegedHostDouble()
    tobs = {k: _t(v) for k, v in env.reset(seed=0).items()}
    policy = cls(tobs, ST_GROUPS, 2, device="cpu", **STUDENTS[name])
    ps = jax.device_get(ts0.policy)
    aux = {"teacher": ps.aux["teacher"], "teacher_norm": None, "memory_t": ps.aux.get("memory_t")}
    from_jax_state(ps.params, _norm_np({"student": ps.norm["student"]}), policy, aux)
    alg = Distillation(policy)
    cs, got, metrics = alg.make_host_collect_fn(env, T)(alg.init_collect_state((), tobs, N),
                                                        action_noise=_jax_noise(ts0.rng, (N, 2)))
    for what in ("actions", "privileged_actions", "rewards"):
        _close(getattr(got, what), getattr(rollout, what), what)
    for k in ("policy", "privileged"):
        _close(got.obs[k], rollout.obs[k], f"obs {k}")
    np.testing.assert_array_equal(got.dones.numpy(), np.asarray(rollout.dones))
    assert set(metrics) == set(cm) and "extras/speed" in metrics
    for k in cm:
        _close(metrics[k], cm[k], f"metric {k}")
    _close_tree(cs.carry, cs1.carry, "final carry")
    for k in ("mean", "var", "count"):
        _close(getattr(policy.norm_student, k), getattr(ts1.policy.norm["student"], k), f"norm {k}")


# ---------------------------------------------------------------- runners


def test_host_env_without_device_trains_on_the_cpu():
    """A host env with no ``device`` trains split through ``learn``; a
    ``fuse_iteration`` request resolves to False, as in the JAX runner."""
    env = CountingHostEnv(num_envs=16, max_episode_length=5)
    assert not hasattr(env, "device")
    runner = OnPolicyRunner(env, _cfg(fuse_iteration=True), device="cpu")
    assert runner.fuse_iteration is False and runner.is_jax_env is False
    runner.learn(2)
    assert runner.current_learning_iteration == 1 and runner.iteration_graph is None
    for row in runner.history:
        assert all(np.isfinite(v) for v in row["metrics"].values())
    assert runner.history[-1]["metrics"]["ep_count"] > 0


def test_distillation_runner_on_a_host_env(tmp_path):
    env = PrivilegedHostDouble()
    cfg = _cfg(obs_groups=dict(ST_GROUPS), policy={"class_name": "StudentTeacherRecurrent", **STUDENTS["gru"]},
               algorithm={"class_name": "Distillation", "gradient_length": 8})
    runner = DistillationRunner(env, cfg, device="cpu")
    runner.alg.policy.loaded_teacher = True
    runner.learn(2)
    assert all(np.isfinite(v) for v in runner.history[-1]["metrics"].values())


@pytest.mark.parametrize("key,value,match", [("iterations_per_dispatch", 2, "iterations_per_dispatch"),
                                             ("eval_interval", 1, "eval_interval")])
def test_runner_refusals(key, value, match):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match=match):
            OnPolicyRunner(CountingHostEnv(), _cfg(**{key: value}), device="cpu")


def test_multiseed_runner_refuses_a_host_env():
    with pytest.raises(ValueError, match="host envs"):
        MultiSeedRunner(CountingHostEnv(), _cfg(), 2, device="cpu")


def test_host_collect_carries_the_episode_sums_across_windows():
    """An episode that spans two windows counts its whole return once it
    ends (the tracker resumes from the collect state's sums)."""
    env = CountingHostEnv(num_envs=4, max_episode_length=6)
    runner = OnPolicyRunner(env, _cfg(num_steps_per_env=4), device="cpu")
    runner.learn(2)
    first, second = (row["metrics"] for row in runner.history)
    assert first["ep_count"] == 0 and second["ep_count"] == 4 and second["ep_length_sum"] == 24
    assert all(t.device.type == "cpu" for t in vars(runner.collect_state.stats).values())
