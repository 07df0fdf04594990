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
from rsl_rl_tpu_torch.env.nlink import NLinkPendulum, NLinkState
from rsl_rl_tpu_torch.modules import ActorCriticRecurrent
from rsl_rl_tpu_torch.ops import distributions, gae, running_norm
from rsl_rl_tpu_torch.storage.rollout import Rollout
from rsl_rl_tpu_torch.utils.weights import from_jax_state

N, LINKS, HID, T = 16, 3, 32, 8
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
POLICY_KW = dict(rnn_type="gru", rnn_hidden_dim=HID, actor_hidden_dims=[32, 32],
                 critic_hidden_dims=[32, 32], actor_obs_normalization=True,
                 critic_obs_normalization=True)
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


def _jax_setup(max_episode_length, randomize):
    env = JaxNLink(N, LINKS, max_episode_length=max_episode_length)
    _, obs = env.reset(jax.random.PRNGKey(0))
    policy = JaxACR(obs, GROUPS, env.num_actions, **POLICY_KW)
    ppo = JaxPPO(policy, **PPO_KW)
    ts = ppo.init_train_state(jax.random.PRNGKey(1), N)
    cs = ppo.init_collect_state(jax.random.PRNGKey(2), env)
    if randomize:
        cs = cs.replace(env_state=env.randomize_episode_length(cs.env_state, jax.random.PRNGKey(3)))
    return env, ppo, ts, cs


def _port_policy(obs, ps):
    policy = ActorCriticRecurrent({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS,
                                  device="cpu", **POLICY_KW)
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
    jenv, jppo, ts0, cs0 = _jax_setup(max_episode_length=1000, randomize=False)
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(jenv, T))(ts0, cs0)
    assert not np.asarray(rollout.dones).any()

    policy = _port_policy(cs0.obs, ts0.policy)
    ppo = PPO(policy, **PPO_KW)
    env = NLinkPendulum(N, LINKS, max_episode_length=1000, device="cpu")
    st = cs0.env_state
    cs = CollectState(
        env_state=NLinkState(_t(st.episode_length), _t(st.theta), _t(st.omega)),
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
        _close(cs.carry[role][0], cs1.carry[role][0], 1e-4, 1e-5, f"final {role} carry")
        state = getattr(policy, f"norm_{role}")
        for k in ("mean", "var", "count"):
            _close(getattr(state, k), getattr(ts1.policy.norm[role], k), 1e-5, 1e-6, f"norm {role} {k}")


def test_recurrent_update_matches_jax():
    """One full update (GAE, 2 epochs x 2 minibatches, adaptive-KL lr,
    global-norm clip, Adam) on a JAX-made rollout with dones: losses and
    every updated parameter at rtol 3e-4 / atol 3e-5."""
    jenv, jppo, ts0, cs0 = _jax_setup(max_episode_length=5, randomize=True)
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(jenv, T))(ts0, cs0)
    dones = np.asarray(rollout.dones)
    assert dones.any() and not dones.all(axis=1).any(), "want desynchronized dones"
    ts2, _, um = jax.jit(jppo.make_update_fn())(ts1, cs1, rollout)

    policy = _port_policy(cs1.obs, ts1.policy)
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
    want = _port_policy(cs1.obs, ts2.policy)
    for (name, got_p), (_, want_p) in zip(policy.named_parameters(), want.named_parameters()):
        _close(got_p, want_p.detach(), 3e-4, 3e-5, f"updated {name}")
