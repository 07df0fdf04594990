"""The port's multi-seed training (``PPO.collect_stacked`` /
``PPO.update_stacked``, ``make_multiseed_train``, ``MultiSeedRunner``)
against ``jax.vmap`` of the JAX package's collect and update, and against the
port's own single-seed runs.

JAX runs on the CPU (its vmapped replay takes the scan path there); the port
runs on the CPU, where its seed-axis replay takes the plain version of the
xproj kernels. Random streams differ between the frameworks, so the collect
test feeds the port the JAX rollout's action noise, and the update test feeds
both the same JAX-made rollout.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu.runners.multiseed import make_multiseed_train as jax_make_multiseed_train
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState, EpisodeStats
from rsl_rl_tpu_torch.env.nlink import NLinkPendulum, NLinkState, env_keys
from rsl_rl_tpu_torch.modules import ActorCriticRecurrent
from rsl_rl_tpu_torch.modules.policy import seed_call
from rsl_rl_tpu_torch.ops import gru_rnn, lstm_rnn
from rsl_rl_tpu_torch.runners import MultiSeedRunner, make_multiseed_train
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils.weights import from_jax_stacked_state, from_jax_state

G, N, LINKS, HID, T = 2, 16, 3, 32, 8
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
POLICY_KW = dict(rnn_type="gru", rnn_hidden_dim=HID, actor_hidden_dims=[32, 32],
                 critic_hidden_dims=[32, 32], actor_obs_normalization=True,
                 critic_obs_normalization=True)
KW = {"gru": POLICY_KW, "lstm": dict(POLICY_KW, rnn_type="lstm")}
PPO_KW = dict(num_learning_epochs=2, num_mini_batches=2)
CFG = {
    "num_steps_per_env": T,
    "seed": 3,
    "obs_groups": GROUPS,
    "policy": {"class_name": "ActorCriticRecurrent", **POLICY_KW},
    "algorithm": {"class_name": "PPO", **PPO_KW},
}


def _t(x):
    return torch.tensor(np.asarray(x))


def _tree_t(tree):
    return tree_map(_t, jax.device_get(tree))


def _norm_np(norm):
    return {k: None if v is None else {"mean": np.asarray(v.mean), "var": np.asarray(v.var),
                                       "count": np.asarray(v.count)}
            for k, v in norm.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _jax_setup(family, max_episode_length, randomize):
    """G seeds of the JAX package's multi-seed init, with per-seed episode
    lengths scattered when ``randomize`` (desynchronized dones)."""
    env = JaxNLink(N, LINKS, max_episode_length=max_episode_length)
    _, obs = env.reset(jax.random.PRNGKey(0))
    ppo = JaxPPO(JaxACR(obs, GROUPS, env.num_actions, **KW[family]), **PPO_KW)
    init, _ = jax_make_multiseed_train(ppo, env, T, G)
    ts, cs = init(jax.random.PRNGKey(1))
    if randomize:
        keys = jax.random.split(jax.random.PRNGKey(2), G)
        cs = cs.replace(env_state=jax.vmap(env.randomize_episode_length)(cs.env_state, keys))
    return env, ppo, ts, cs


def _port_stacked(family, obs, policy_state):
    """A port PPO and a stacked training state holding the JAX seeds' weights."""
    template = ActorCriticRecurrent({k: _t(v[0]) for k, v in obs.items()}, GROUPS, LINKS, device="cpu",
                                    **KW[family])
    ppo = PPO(template, **PPO_KW)
    ts = ppo.init_stacked_state([copy.deepcopy(template) for _ in range(G)])
    from_jax_stacked_state(jax.device_get(policy_state.params), _norm_np(policy_state.norm), template, ts)
    return ppo, ts


def _port_rollout(rollout):
    return Rollout(
        obs={k: _t(v) for k, v in rollout.obs.items()},
        actions=_t(rollout.actions), rewards=_t(rollout.rewards), dones=_t(rollout.dones),
        values=_t(rollout.values), log_probs=_t(rollout.log_probs), mu=_t(rollout.mu),
        sigma=_t(rollout.sigma), carry0=_tree_t(rollout.carry0),
    )


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_stacked_update_matches_vmapped_jax(family):
    """One multi-seed update (GAE, 2 epochs x 2 minibatches, per-seed
    adaptive-KL lr, global-norm clip and Adam) on a JAX-made rollout with
    per-seed desynchronized dones equals ``jax.vmap(update)``: every
    per-seed loss and every updated parameter of every seed at rtol 3e-4 /
    atol 3e-5."""
    jenv, jppo, ts0, cs0 = _jax_setup(family, max_episode_length=5, randomize=True)
    ts1, cs1, rollout, _ = jax.jit(jax.vmap(jppo.make_collect_fn(jenv, T)))(ts0, cs0)
    dones = np.asarray(rollout.dones)
    assert dones.any() and not (dones[0] == dones[1]).all(), "want per-seed desynchronized dones"
    ts2, _, um = jax.jit(jax.vmap(jppo.make_update_fn()))(ts1, cs1, rollout)

    ppo, ts = _port_stacked(family, cs1.obs, ts1.policy)
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()},
                      carry=_tree_t(cs1.carry), stats=None)
    ts, _, metrics = ppo.update_stacked(ts, cs, _port_rollout(rollout))

    um = jax.device_get(um)
    assert set(metrics) == set(um)
    for k in um:
        assert metrics[k].shape == (G,), k
        _close(metrics[k], um[k], 3e-4, 3e-5, f"metric {k}")
    _, want = _port_stacked(family, cs1.obs, ts2.policy)
    for name, got_p in ts.params.items():
        _close(got_p, want.params[name], 3e-4, 3e-5, f"updated {name}")
    _close(ts.lr, ts2.lr, 1e-6, 0.0, "lr")


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_stacked_collect_matches_vmapped_jax(family):
    """A multi-seed collection window (no time-out in it) with each seed's
    action noise injected equals ``jax.vmap(collect)``: the rollout, the
    final carries and each seed's normalizer moments."""
    jenv, jppo, ts0, cs0 = _jax_setup(family, max_episode_length=1000, randomize=False)
    ts1, cs1, rollout, cm = jax.jit(jax.vmap(jppo.make_collect_fn(jenv, T)))(ts0, cs0)
    assert not np.asarray(rollout.dones).any()

    ppo, ts = _port_stacked(family, cs0.obs, ts0.policy)
    env = NLinkPendulum(N, LINKS, max_episode_length=1000, device="cpu")
    st = jax.device_get(cs0.env_state)
    flat = [_t(x).reshape(G * N, *np.shape(x)[2:]) for x in (st.episode_length, st.theta, st.omega)]
    cs = ppo.init_stacked_collect_state(NLinkState(*flat, env_keys(0, G * N)), {k: _t(v) for k, v in cs0.obs.items()}, G)
    noise = (np.asarray(rollout.actions) - np.asarray(rollout.mu)) / np.asarray(rollout.sigma)
    cs, got, metrics = ppo.collect_stacked(env, ts, cs, T, action_noise=torch.tensor(noise))

    for name in ("actions", "rewards", "values", "log_probs", "mu", "sigma"):
        _close(getattr(got, name), getattr(rollout, name), 1e-4, 1e-5, name)
    _close(got.obs["policy"], rollout.obs["policy"], 1e-4, 1e-5, "obs")
    np.testing.assert_array_equal(got.dones.numpy(), np.asarray(rollout.dones))
    for k in ("Policy/mean_noise_std", "extras/nlink/tip_height"):
        _close(metrics[k], cm[k], 1e-4, 1e-5, k)
    for role in ("actor", "critic"):
        for a, b in zip(jax.tree_util.tree_leaves(cs.carry[role]), jax.tree_util.tree_leaves(cs1.carry[role])):
            _close(a, b, 1e-4, 1e-5, f"final {role} carry")
        for k in ("mean", "var", "count"):
            _close(ts.buffers[f"norm_{role}.{k}"], getattr(ts1.policy.norm[role], k), 1e-5, 1e-6,
                   f"norm {role} {k}")


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_each_seed_equals_its_standalone_run(family):
    """Seed i of a G-seed run equals a single-seed port run from seed i's rows
    of the stacked state (its envs' keys included, so the resets draw the
    same states) over 2 iterations (with dones), losses and final parameters:
    any reduction across seeds would break it."""
    cfg = copy.deepcopy(CFG)
    cfg["policy"].update(KW[family])
    cfg["policy"]["class_name"] = "ActorCriticRecurrent"
    env = NLinkPendulum(N, LINKS, max_episode_length=6, device="cpu")
    runner = MultiSeedRunner(env, cfg, G, device="cpu")
    alg, ts, cs = runner.alg, runner.train_state, runner.collect_state
    cs.env_state.episode_length = torch.randint(0, 6, (G * N,), generator=torch.Generator().manual_seed(4),
                                                dtype=torch.int32)
    start_ts, start_cs = copy.deepcopy(ts), copy.deepcopy(cs)
    noise = torch.randn(2, G, T, N, LINKS, generator=torch.Generator().manual_seed(5))
    _, step = make_multiseed_train(alg, env, T, G, device="cpu")
    batched = []
    for it in range(2):
        ts, cs, m = step(ts, cs, action_noise=noise[it])
        batched.append(m)
    assert any(float(m["ep_count"][i]) > 0 for m in batched for i in range(G)), "want dones"

    for i in range(G):
        policy = copy.deepcopy(alg.policy)
        with torch.no_grad():
            for name, p in policy.named_parameters():
                p.copy_(start_ts.params[name][i])
            for name, b in policy.named_buffers():
                b.copy_(start_ts.buffers[name][i])
        ppo = PPO(policy, **PPO_KW)
        ref_env = NLinkPendulum(N, LINKS, max_episode_length=6, device="cpu")
        pick = lambda tree: tree_map(lambda t: t[i], tree)  # noqa: E731
        rows = slice(i * N, (i + 1) * N)
        single = CollectState(
            env_state=NLinkState(**{k: v[rows] for k, v in vars(start_cs.env_state).items()}),
            obs=pick(start_cs.obs), carry=pick(start_cs.carry),
            stats=EpisodeStats(*(x[i] for x in vars(start_cs.stats).values())))
        for it in range(2):
            single, rollout, cm = ppo.collect(ref_env, single, T, action_noise=noise[it, i])
            single, um = ppo.update(single, rollout)
            for k, v in {**cm, **um}.items():
                _close(batched[it][k][i], v, 1e-4, 1e-5, f"seed {i} iteration {it} {k}")
        for name, p in policy.named_parameters():
            _close(ts.params[name][i], p, 1e-4, 1e-5, f"seed {i} {name}")


def test_seeds_have_distinct_losses():
    """Three seeds of one config train to three different losses, each
    metric with a leading seed axis; the runner keeps per-seed reward windows."""
    env = NLinkPendulum(N, LINKS, max_episode_length=4, device="cpu")
    runner = MultiSeedRunner(env, copy.deepcopy(CFG), 3, device="cpu")
    runner.learn(2)
    metrics = runner.history[-1]["metrics"]
    assert all(v.shape == (3,) and np.isfinite(v).all() for v in metrics.values())
    assert len({float(x) for x in metrics["Loss/value_function"]}) == 3, "seeds produced identical losses"
    rewards, count = runner.seed_rewards()
    assert rewards.shape == (3,) and count > 0


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_seed_axis_replay_routes_to_xproj(family, monkeypatch):
    """Under the seed axis the policy's replay takes the xproj replay (one
    call for seeds x actor/critic streams, forward and backward), never the
    x-streaming one; without it the same replay takes the x-streaming one.
    Pins the routing decision on the CPU, where each wrapper takes its plain
    version."""
    mod = gru_rnn if family == "gru" else lstm_rnn
    calls = []

    def refuse(*args, **kwargs):
        raise AssertionError("the x-streaming replay ran under the seed axis")

    for name in (f"{family}_xp_plain_fwd", f"{family}_xp_plain_bwd"):
        real = getattr(mod, name)

        def record(*args, _real=real, _name=name, **kwargs):
            calls.append((_name, args[0].shape[0]))
            return _real(*args, **kwargs)

        monkeypatch.setattr(mod, name, record)
    x_fwd = getattr(mod, f"{family}_x_plain_fwd")
    monkeypatch.setattr(mod, f"{family}_x_plain_fwd", refuse)
    monkeypatch.setattr(mod, f"{family}_x_plain_bwd", refuse)

    torch.manual_seed(0)
    obs = {"policy": torch.randn(N, 3 * LINKS)}
    policies = [ActorCriticRecurrent(obs, GROUPS, LINKS, device="cpu", seed=s, **KW[family]) for s in range(G)]
    ppo = PPO(policies[0], **PPO_KW)
    ts = ppo.init_stacked_state(policies)
    seq_obs = {"policy": torch.randn(G, T, N, 3 * LINKS)}
    carry0 = tree_map(lambda t: t.expand(G, *t.shape).clone(), policies[0].initial_carry(N))
    resets = torch.rand(G, T, N) < 0.2
    mean, _, value = seed_call(policies[0], ts.params, ts.buffers, "act_value_seq", seq_obs, carry0, resets)
    torch.autograd.grad(mean.sum() + value.sum(), list(ts.params.values()), allow_unused=True)
    assert calls == [(f"{family}_xp_plain_fwd", 2 * G), (f"{family}_xp_plain_bwd", 2 * G)]

    picked = []
    monkeypatch.setattr(mod, f"{family}_x_plain_fwd", lambda *a: (picked.append("x"), x_fwd(*a))[1])
    policies[0].act_value_seq({"policy": seq_obs["policy"][0]}, tree_map(lambda t: t[0], carry0), resets[0])
    assert picked == ["x"]


def test_multiseed_requires_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    env = NLinkPendulum(N, LINKS, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiSeedRunner(env, copy.deepcopy(CFG), G)
    runner = MultiSeedRunner(env, copy.deepcopy(CFG), G, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_multiseed_train(runner.alg, env, T, G)


def test_study_writes_and_resumes_its_checkpoints(tmp_path):
    """With a ``log_dir`` the study saves ``model_<it>.pt`` every
    ``save_interval`` iterations and at the end; ``load_latest`` restores
    every seed's parameters, normalizer moments, Adam state and learning rate
    bit for bit, and the resumed study then trains as the original does. A
    checkpoint of another seed count is refused."""
    cfg = dict(copy.deepcopy(CFG), save_interval=2)
    a = MultiSeedRunner(NLinkPendulum(N, LINKS, device="cpu"), cfg, G, log_dir=str(tmp_path), device="cpu")
    a.learn(3)
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("model_")) == ["model_0.pt", "model_2.pt"]
    b = MultiSeedRunner(NLinkPendulum(N, LINKS, device="cpu"), copy.deepcopy(cfg), G, device="cpu")
    assert b.load_latest(str(tmp_path)) and b.current_learning_iteration == 2

    def leaves(ts):
        return [*ts.params.values(), *ts.buffers.values(), *ts.adam_mu.values(), *ts.adam_nu.values(),
                ts.adam_count, ts.lr]

    for x, y in zip(leaves(a.train_state), leaves(b.train_state)):
        assert torch.equal(x, y)
    b.collect_state = copy.deepcopy(a.collect_state)
    b.alg.generator.set_state(a.alg.generator.get_state())
    a.learn(1)
    b.learn(1)
    for x, y in zip(leaves(a.train_state), leaves(b.train_state)):
        assert torch.equal(x, y)
    other = MultiSeedRunner(NLinkPendulum(N, LINKS, device="cpu"), copy.deepcopy(CFG), G + 1, device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        other.load(os.path.join(tmp_path, "model_2.pt"))


def test_stacked_jax_weights_load_one_seed_or_all():
    """``from_jax_stacked_state`` carries seed-stacked JAX trees into the
    stacked state: all seeds, or one seed leaving the others as they were."""
    _, _, ts0, cs0 = _jax_setup("gru", max_episode_length=1000, randomize=False)
    ppo, ts = _port_stacked("gru", cs0.obs, ts0.policy)
    params_np, norm_np = jax.device_get(ts0.policy.params), _norm_np(ts0.policy.norm)
    for i in range(G):
        single = copy.deepcopy(ppo.policy)
        pick = lambda tree: jax.tree_util.tree_map(lambda x: x[i], tree)  # noqa: E731
        from_jax_state(pick(params_np), pick(norm_np), single)
        for name, p in single.named_parameters():
            torch.testing.assert_close(ts.params[name][i], p.detach(), rtol=0, atol=0)
    fresh = ppo.init_stacked_state([copy.deepcopy(ppo.policy) for _ in range(G)])
    before = {k: v.detach().clone() for k, v in fresh.params.items()}
    from_jax_stacked_state(params_np, norm_np, ppo.policy, fresh, seeds=1)
    for name, v in fresh.params.items():
        torch.testing.assert_close(v[0], before[name][0], rtol=0, atol=0)
        torch.testing.assert_close(v[1], ts.params[name][1], rtol=0, atol=0)
