"""The port's PPO slice against the JAX package: the math ops, a collection
window, and one full recurrent PPO update, from the same weights and inputs.

JAX runs on the CPU (its recurrent replay takes the scan path there); the
port runs its plain versions on the CPU. Random streams differ between the
frameworks, so the collect test recovers the action noise from the JAX
rollout and feeds it to the port, and the update test feeds both the same
JAX-made rollout. The recurrent update has no permutation, so it is
deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu.ops import distributions as jdist
from rsl_rl_tpu.ops import gae as jgae
from rsl_rl_tpu.ops import running_norm as jnorm
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState, init_episode_stats
from rsl_rl_tpu_torch.env.nlink import NLinkPendulum, NLinkState, env_keys
from rsl_rl_tpu_torch.modules import ActorCriticRecurrent
from rsl_rl_tpu_torch.ops import distributions, gae, running_norm
from rsl_rl_tpu_torch.storage.rollout import Rollout
from rsl_rl_tpu_torch.utils.weights import from_jax_state

N, LINKS, HID, T = 16, 3, 32, 8
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
POLICY_KW = dict(rnn_type="gru", rnn_hidden_dim=HID, actor_hidden_dims=[32, 32],
                 critic_hidden_dims=[32, 32], actor_obs_normalization=True,
                 critic_obs_normalization=True)
LSTM_KW = dict(POLICY_KW, rnn_type="lstm")
PPO_KW = dict(num_learning_epochs=2, num_mini_batches=2)


def _t(x):
    return torch.tensor(np.asarray(x))


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_t(v) for v in tree)
    return _t(tree)


def _norm_np(norm):
    return {k: None if v is None else {"mean": np.asarray(v.mean), "var": np.asarray(v.var),
                                       "count": np.asarray(v.count)}
            for k, v in norm.items()}


def _close(got, want, rtol, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _close_tree(got, want, rtol, atol, what):
    """:func:`_close` over a carry: a tensor or nested tuples of them."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, rtol, atol, f"{what}[{i}]")
    else:
        _close(got, want, rtol, atol, what)


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("fn", ["log_prob", "entropy", "kl_divergence"])
def test_distributions_match(fn):
    rng = np.random.default_rng(0)
    mean, val, mean2 = (rng.normal(size=(7, 5)).astype(np.float32) for _ in range(3))
    std, std2 = (rng.uniform(0.2, 2.0, size=(7, 5)).astype(np.float32) for _ in range(2))
    args = {"log_prob": (mean, std, val), "entropy": (std,),
            "kl_divergence": (mean, std, mean2, std2)}[fn]
    want = getattr(jdist, fn)(*map(jnp.asarray, args))
    _close(getattr(distributions, fn)(*map(torch.tensor, args)), want, 1e-6, 1e-6, fn)
    noise = rng.normal(size=(7, 5)).astype(np.float32)
    sample = distributions.sample(torch.tensor(mean), torch.tensor(std), torch.tensor(noise))
    _close(sample, mean + std * noise, 1e-6, 1e-6, "sample")


@pytest.mark.parametrize("until", [None, 40.0, 0.0], ids=["never", "freeze_at_40", "frozen"])
def test_running_norm_matches(until):
    rng = np.random.default_rng(1)
    jstate = jnorm.init_running_norm(4, until=until)
    state = running_norm.RunningNormState(4, until=until)
    for _ in range(5):
        x = rng.normal(loc=2.0, scale=3.0, size=(16, 4)).astype(np.float32)
        jstate = jnorm.update_running_norm(jstate, jnp.asarray(x))
        running_norm.update_running_norm(state, torch.tensor(x))
        for k in ("mean", "var", "count"):
            _close(getattr(state, k), getattr(jstate, k), 1e-6, 1e-6, k)
        _close(running_norm.normalize(state, torch.tensor(x)), jnorm.normalize(jstate, jnp.asarray(x)),
               1e-5, 1e-6, "normalize")


@pytest.mark.parametrize("normalize", [True, False])
def test_gae_matches(normalize):
    rng = np.random.default_rng(2)
    rew, val = (rng.normal(size=(T, N)).astype(np.float32) for _ in range(2))
    dones = rng.random((T, N)) < 0.2
    last = rng.normal(size=(N,)).astype(np.float32)
    want = jgae.compute_gae(jnp.asarray(rew), jnp.asarray(val), jnp.asarray(dones), jnp.asarray(last),
                            0.99, 0.95, normalize_advantage=normalize)
    got = gae.compute_gae(_t(rew), _t(val), _t(dones), _t(last), 0.99, 0.95, normalize_advantage=normalize)
    for g, w, name in zip(got, want, ("returns", "advantages")):
        _close(g, w, 1e-5, 1e-5, name)


# ------------------------------------------------------------ JAX setup


def _jax_setup(max_episode_length, randomize, policy_kw=POLICY_KW):
    env = JaxNLink(N, LINKS, max_episode_length=max_episode_length)
    _, obs = env.reset(jax.random.PRNGKey(0))
    policy = JaxACR(obs, GROUPS, env.num_actions, **policy_kw)
    ppo = JaxPPO(policy, **PPO_KW)
    ts = ppo.init_train_state(jax.random.PRNGKey(1), N)
    cs = ppo.init_collect_state(jax.random.PRNGKey(2), env)
    if randomize:
        cs = cs.replace(env_state=env.randomize_episode_length(cs.env_state, jax.random.PRNGKey(3)))
    return env, ppo, ts, cs


def _port_policy(obs, ps, policy_kw=POLICY_KW):
    policy = ActorCriticRecurrent({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS,
                                  device="cpu", **policy_kw)
    from_jax_state(jax.device_get(ps.params), _norm_np(ps.norm), policy)
    return policy


@pytest.mark.parametrize("std_type,floor", [("scalar", None), ("log", None), ("log", 0.8)],
                         ids=["scalar", "log", "log_floor"])
def test_acting_matches_jax_for_each_std_mode(std_type, floor):
    """One acting step (``act``, ``value``, ``act_inference``) from the same
    weights, normalizer moments and carry, for each action-std mode."""
    jenv = JaxNLink(N, LINKS)
    _, obs = jenv.reset(jax.random.PRNGKey(4))
    kw = dict(POLICY_KW, noise_std_type=std_type, noise_std_floor=floor, init_noise_std=0.7)
    jpolicy = JaxACR(obs, GROUPS, jenv.num_actions, **kw)
    ps = jpolicy.init(jax.random.PRNGKey(5))
    ps = jpolicy.update_normalization(ps, obs)
    rng = np.random.default_rng(6)
    carry = {k: (rng.normal(size=(N, HID)).astype(np.float32),) for k in ("actor", "critic")}
    jcarry = {k: tuple(map(jnp.asarray, v)) for k, v in carry.items()}
    want_mean, want_std, _ = jpolicy.act(ps, obs, jcarry)
    want_value, _ = jpolicy.value(ps, obs, jcarry)
    want_inf, _ = jpolicy.act_inference(ps, obs, jcarry)

    policy = ActorCriticRecurrent({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS, device="cpu", **kw)
    from_jax_state(jax.device_get(ps.params), _norm_np(ps.norm), policy)
    tobs, tcarry = {k: _t(v) for k, v in obs.items()}, _tree_t(carry)
    with torch.no_grad():
        mean, std, _ = policy.act(tobs, tcarry)
        value, _ = policy.value(tobs, tcarry)
        inf, _ = policy.act_inference(tobs, tcarry)
    for name, got, want in (("mean", mean, want_mean), ("std", std, want_std), ("value", value, want_value),
                            ("act_inference", inf, want_inf)):
        _close(got, want, 1e-5, 1e-5, name)
    if floor is not None:
        assert float(std.min()) == pytest.approx(floor)


def test_collect_window_matches_jax():
    """No time-out in the window; the port replays the JAX action noise."""
    _check_collect_window(POLICY_KW)


def test_lstm_collect_window_matches_jax():
    """The same with LSTM memories: a ``(c, h)`` carry per layer."""
    _check_collect_window(LSTM_KW)


def _check_collect_window(policy_kw):
    jenv, jppo, ts0, cs0 = _jax_setup(max_episode_length=1000, randomize=False, policy_kw=policy_kw)
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(jenv, T))(ts0, cs0)
    assert not np.asarray(rollout.dones).any()

    policy = _port_policy(cs0.obs, ts0.policy, policy_kw)
    ppo = PPO(policy, **PPO_KW)
    env = NLinkPendulum(N, LINKS, max_episode_length=1000, device="cpu")
    st = cs0.env_state
    cs = CollectState(
        env_state=NLinkState(_t(st.episode_length), _t(st.theta), _t(st.omega), env_keys(0, N)),
        obs={k: _t(v) for k, v in cs0.obs.items()},
        carry=policy.initial_carry(N),
        stats=init_episode_stats(N, "cpu"),
    )
    noise = (np.asarray(rollout.actions) - np.asarray(rollout.mu)) / np.asarray(rollout.sigma)
    cs, got, _ = ppo.collect(env, cs, T, action_noise=torch.tensor(noise))

    for name in ("actions", "rewards", "values", "log_probs", "mu", "sigma"):
        _close(getattr(got, name), getattr(rollout, name), 1e-4, 1e-5, name)
    _close(got.obs["policy"], rollout.obs["policy"], 1e-4, 1e-5, "obs")
    np.testing.assert_array_equal(got.dones.numpy(), np.asarray(rollout.dones))
    for role in ("actor", "critic"):
        _close_tree(cs.carry[role], cs1.carry[role], 1e-4, 1e-5, f"final {role} carry")
        state = getattr(policy, f"norm_{role}")
        for k in ("mean", "var", "count"):
            _close(getattr(state, k), getattr(ts1.policy.norm[role], k), 1e-5, 1e-6, f"norm {role} {k}")


def test_recurrent_update_matches_jax():
    """One full update (GAE, 2 epochs x 2 minibatches, adaptive-KL lr,
    global-norm clip, Adam) on a JAX-made rollout with dones: losses and
    every updated parameter at rtol 3e-4 / atol 3e-5."""
    _check_update(POLICY_KW)


def test_lstm_recurrent_update_matches_jax():
    """The same with LSTM memories in fp32: the window-start ``(c, h)``
    carries are sliced per minibatch and replayed with the rollout's resets."""
    _check_update(LSTM_KW)


def _check_update(policy_kw):
    jenv, jppo, ts0, cs0 = _jax_setup(max_episode_length=5, randomize=True, policy_kw=policy_kw)
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(jenv, T))(ts0, cs0)
    dones = np.asarray(rollout.dones)
    assert dones.any() and not dones.all(axis=1).any(), "want desynchronized dones"
    ts2, _, um = jax.jit(jppo.make_update_fn())(ts1, cs1, rollout)

    policy = _port_policy(cs1.obs, ts1.policy, policy_kw)
    ppo = PPO(policy, **PPO_KW)
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()},
                      carry=_tree_t(jax.device_get(cs1.carry)), stats=None)
    port_rollout = Rollout(
        obs={k: _t(v) for k, v in rollout.obs.items()},
        actions=_t(rollout.actions), rewards=_t(rollout.rewards), dones=_t(rollout.dones),
        values=_t(rollout.values), log_probs=_t(rollout.log_probs), mu=_t(rollout.mu),
        sigma=_t(rollout.sigma), carry0=_tree_t(jax.device_get(rollout.carry0)),
    )
    _, metrics = ppo.update(cs, port_rollout)

    um = jax.device_get(um)
    assert set(metrics) == set(um)
    for k in um:
        _close(metrics[k], um[k], 3e-4, 3e-5, f"metric {k}")
    want = _port_policy(cs1.obs, ts2.policy, policy_kw)
    for (name, got_p), (_, want_p) in zip(policy.named_parameters(), want.named_parameters()):
        _close(got_p, want_p.detach(), 3e-4, 3e-5, f"updated {name}")


# ------------------------------------------------------- runner config keys

from rsl_rl_tpu.algorithms.ppo import resolve_num_mini_batches as jax_resolve_num_mini_batches  # noqa: E402
from rsl_rl_tpu.runners import OnPolicyRunner as JaxRunner  # noqa: E402
from rsl_rl_tpu_torch.algorithms.ppo import resolve_num_mini_batches  # noqa: E402
from rsl_rl_tpu_torch.runners import OnPolicyRunner  # noqa: E402


def _runner_cfg(**overrides):
    cfg = {
        "num_steps_per_env": 2,
        "save_interval": 50,
        "seed": 3,
        "obs_groups": GROUPS,
        "policy": {"class_name": "ActorCriticRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 8,
                   "actor_hidden_dims": [8], "critic_hidden_dims": [8]},
        "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2},
    }
    cfg.update(overrides)
    return cfg


def test_empirical_normalization_maps_like_jax():
    """A config that sets only the deprecated ``empirical_normalization``
    normalizes the actor and critic observations in both packages, and the
    port warns as the JAX package does."""
    cfg = _runner_cfg(empirical_normalization=True)
    with pytest.warns(DeprecationWarning, match="empirical_normalization"):
        jrunner = JaxRunner(JaxNLink(8, LINKS), cfg, log_dir=None)
    with pytest.warns(DeprecationWarning, match="empirical_normalization"):
        runner = OnPolicyRunner(NLinkPendulum(8, LINKS, device="cpu"), cfg, device="cpu")
    jpolicy, policy = jrunner.alg.policy, runner.alg.policy
    assert jpolicy.actor_obs_normalization and jpolicy.critic_obs_normalization
    assert policy.norm_actor is not None and policy.norm_critic is not None
    assert "actor_obs_normalization" not in cfg["policy"]  # the caller's config is not changed


def test_empirical_normalization_leaves_set_keys():
    """Keys the policy config sets win over the deprecated one."""
    cfg = _runner_cfg(empirical_normalization=True)
    cfg["policy"] = dict(cfg["policy"], critic_obs_normalization=False)
    with pytest.warns(DeprecationWarning):
        runner = OnPolicyRunner(NLinkPendulum(8, LINKS, device="cpu"), cfg, device="cpu")
    assert runner.alg.policy.norm_actor is not None and runner.alg.policy.norm_critic is None


UNPORTED_SETTINGS = {"eval_interval": 10, "model_parallel_size": 2}


@pytest.mark.parametrize("key", sorted(UNPORTED_SETTINGS))
def test_unported_runner_key_raises(key):
    """The runner keys the port once refused, ported since. ``eval_interval``:
    the runner takes it. ``model_parallel_size: 2`` in one process (no
    process group: one rank) raises ``ValueError("must divide")``, as the
    JAX runner does for a model axis its devices do not divide
    (``tests/test_tensor_parallel.py:87-102``); at 1 the runner trains on
    one process, with no mesh."""
    env = NLinkPendulum(8, LINKS, device="cpu")
    if key == "eval_interval":
        with pytest.warns(UserWarning, match=key):
            assert OnPolicyRunner(env, _runner_cfg(**{key: UNPORTED_SETTINGS[key]}), device="cpu").eval_interval == 10
        return
    with pytest.raises(ValueError, match="must divide"):
        OnPolicyRunner(env, _runner_cfg(**{key: UNPORTED_SETTINGS[key]}), device="cpu")
    assert OnPolicyRunner(env, _runner_cfg(**{key: 1}), device="cpu").mesh is None


@pytest.mark.parametrize("recurrent", [True, False], ids=["recurrent", "feedforward"])
@pytest.mark.parametrize("setting,steps,envs", [
    ("auto", 24, 4096), ("auto", 24, 512), ("auto", 24, 16384), ("auto", 24, 65536), ("auto", 8, 16),
    ("auto", 24, 3000), ("auto", 7, 12288), ("auto", 100, 1000), (6, 24, 4096), ("8", 24, 512),
])
def test_resolve_num_mini_batches_matches_jax(setting, steps, envs, recurrent):
    got = resolve_num_mini_batches(setting, steps, envs, recurrent)
    assert got == jax_resolve_num_mini_batches(setting, steps, envs, recurrent)


def test_auto_minibatches_update_like_the_resolved_count():
    """``num_mini_batches="auto"`` resolves at update time (here to 4) and the
    recurrent update then equals one configured with 4."""
    histories = []
    for setting in ("auto", 4):
        cfg = _runner_cfg()
        cfg["algorithm"] = dict(cfg["algorithm"], num_mini_batches=setting)
        runner = OnPolicyRunner(NLinkPendulum(8, LINKS, device="cpu"), cfg, device="cpu")
        assert runner.alg.num_mini_batches == setting
        runner.learn(1)
        histories.append(runner.history[0]["metrics"])
    assert histories[0].keys() == histories[1].keys()
    for k in histories[0]:
        assert histories[0][k] == pytest.approx(histories[1][k], rel=1e-6, abs=1e-7), k


def test_rnn_hidden_size_is_a_deprecated_alias():
    """The deprecated ``rnn_hidden_size`` builds memories of that width and
    warns (JAX ``tests/test_modules.py:190``), unless ``rnn_hidden_dim`` is
    set too."""
    import warnings

    obs = {"policy": torch.zeros(4, 3 * LINKS)}
    with pytest.warns(DeprecationWarning, match="rnn_hidden_size"):
        policy = ActorCriticRecurrent(obs, GROUPS, LINKS, rnn_type="gru", rnn_hidden_size=32,
                                      actor_hidden_dims=[8], critic_hidden_dims=[8], device="cpu")
    assert policy.rnn_hidden_dim == 32
    assert policy.memory_a.hidden_size == policy.memory_c.hidden_size == 32
    assert policy.initial_carry(4)["actor"][0].shape == (4, 32)
    with pytest.warns(DeprecationWarning):
        policy = ActorCriticRecurrent(obs, GROUPS, LINKS, rnn_type="gru", rnn_hidden_size=32, rnn_hidden_dim=16,
                                      actor_hidden_dims=[8], critic_hidden_dims=[8], device="cpu")
    assert policy.memory_a.hidden_size == 16
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ActorCriticRecurrent(obs, GROUPS, LINKS, rnn_type="gru", rnn_hidden_dim=16, device="cpu")


def _twice(obs, actions, env):
    """An augmentation of two identical copies."""
    return (None if obs is None else {k: torch.cat([v, v]) for k, v in obs.items()},
            None if actions is None else torch.cat([actions, actions]))


@pytest.mark.parametrize("key", ["rnd_cfg", "symmetry_cfg"])
def test_multiseed_refuses_rnd_and_symmetry(key):
    """A study once refused RND and symmetry; it now resolves both configs as
    the single-seed runner does (RND's sizes, its ``rnd_state`` obs set and
    ``step_dt`` scaling; symmetry's env) and trains with them
    (``tests/test_torch_port_multiseed_options.py`` holds them against JAX)."""
    from rsl_rl_tpu_torch.runners import MultiSeedRunner

    cfg = _runner_cfg()
    option = ({"weight": 1.0, "num_outputs": 4, "predictor_hidden_dims": [8], "target_hidden_dims": [8]}
              if key == "rnd_cfg" else
              {"use_data_augmentation": True, "use_mirror_loss": False, "mirror_loss_coeff": 0.0,
               "data_augmentation_func": _twice})
    cfg["algorithm"] = dict(cfg["algorithm"], **{key: option})
    env = NLinkPendulum(8, LINKS, device="cpu")
    if key == "rnd_cfg":
        with pytest.warns(UserWarning, match="rnd_state"):
            study = MultiSeedRunner(env, cfg, 2, device="cpu")
        assert study.alg.rnd.num_states == 3 * LINKS
        assert np.isclose(study.alg.rnd.initial_weight, env.step_dt)
        assert study.train_state.rnd_count.shape == (2,)
    else:
        study = MultiSeedRunner(env, cfg, 2, device="cpu")
        assert study.alg.symmetry["_env"] is env
    study.learn(1)
    assert all(np.isfinite(v).all() for v in study.history[0]["metrics"].values())
