"""The port's feedforward PPO against the JAX package: the packed
minibatch rows, a collection window, one full update (fp32 and bf16
trunks) and the stacked update of G seeds, from the same weights, inputs
and permutation; and each seed of a stacked run against its own
single-seed run.

JAX runs on the CPU. Random streams differ between the frameworks, so the
collect test recovers the action noise from the JAX rollout and feeds it to
the port, and the update tests feed both the JAX-made rollout and the
permutation the JAX update draws from its key.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.algorithms.ppo import pack_minibatch_rows as jax_pack_minibatch_rows
from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu.modules import ActorCritic as JaxAC
from rsl_rl_tpu.runners.multiseed import make_multiseed_train as jax_make_multiseed_train
from rsl_rl_tpu.storage.rollout import Rollout as JaxRollout
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState, EpisodeStats, init_episode_stats, pack_minibatch_rows
from rsl_rl_tpu_torch.env.nlink import NLinkPendulum, NLinkState, env_keys
from rsl_rl_tpu_torch.modules import ActorCritic
from rsl_rl_tpu_torch.runners import MultiSeedRunner
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils.weights import from_jax_stacked_state, from_jax_state

G, N, LINKS, T = 2, 16, 3, 8
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
POLICY_KW = dict(actor_hidden_dims=[32, 32], critic_hidden_dims=[32, 32], actor_obs_normalization=True,
                 critic_obs_normalization=True, noise_std_floor=0.01)
PPO_KW = dict(num_learning_epochs=2, num_mini_batches=4)
#: (rtol, atol) of the port against JAX: fp32, and bf16 trunks (each side
#: rounds its own trunk activations to bf16)
BARS = {"fp32": (3e-4, 3e-5), "bf16": (5e-2, 3e-2)}
DTYPES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(x):
    return torch.tensor(np.asarray(x))


def _norm_np(norm):
    return {k: None if v is None else {"mean": np.asarray(v.mean), "var": np.asarray(v.var),
                                       "count": np.asarray(v.count)}
            for k, v in norm.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _jax_setup(max_episode_length, randomize, dtype=None):
    env = JaxNLink(N, LINKS, max_episode_length=max_episode_length)
    _, obs = env.reset(jax.random.PRNGKey(0))
    ppo = JaxPPO(JaxAC(obs, GROUPS, env.num_actions, dtype=dtype, **POLICY_KW), **PPO_KW)
    ts = ppo.init_train_state(jax.random.PRNGKey(1), N)
    cs = ppo.init_collect_state(jax.random.PRNGKey(2), env)
    if randomize:
        cs = cs.replace(env_state=env.randomize_episode_length(cs.env_state, jax.random.PRNGKey(3)))
    return env, ppo, ts, cs


def _port_policy(obs, ps, dtype=None):
    policy = ActorCritic({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS, device="cpu", dtype=dtype,
                         **POLICY_KW)
    from_jax_state(jax.device_get(ps.params), _norm_np(ps.norm), policy)
    return policy


def _port_rollout(rollout):
    return Rollout(
        obs={k: _t(v) for k, v in rollout.obs.items()},
        actions=_t(rollout.actions), rewards=_t(rollout.rewards), dones=_t(rollout.dones),
        values=_t(rollout.values), log_probs=_t(rollout.log_probs), mu=_t(rollout.mu),
        sigma=_t(rollout.sigma), carry0=(),
    )


def _jax_perm(rng, rows):
    """The permutation the JAX update draws from its train state's key."""
    return jax.random.permutation(jax.random.split(rng)[1], rows)


def test_pack_minibatch_rows_matches_jax_exactly():
    """The packed rows and each unpacked field equal the JAX package's bit
    for bit, for one permutation and, per seed, for a stack of two."""
    rng = np.random.default_rng(0)
    fields = {
        "obs": {"policy": rng.normal(size=(T, N, 6)).astype(np.float32),
                "aux": rng.normal(size=(T, N, 2, 3)).astype(np.float32)},
        "actions": rng.normal(size=(T, N, LINKS)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": rng.random((T, N)) < 0.2,
        **{k: rng.normal(size=(T, N)).astype(np.float32) for k in ("values", "log_probs")},
        **{k: rng.normal(size=(T, N, LINKS)).astype(np.float32) for k in ("mu", "sigma")},
    }
    returns, advantages = (rng.normal(size=(T, N)).astype(np.float32) for _ in range(2))
    perm = rng.permutation(T * N)[: T * N - 4]
    want, jax_unpack = jax_pack_minibatch_rows(
        JaxRollout(**jax.tree_util.tree_map(jnp.asarray, fields)), jnp.asarray(returns), jnp.asarray(advantages),
        jnp.asarray(perm))
    got, unpack = pack_minibatch_rows(Rollout(**tree_map(_t, fields)), _t(returns), _t(advantages), _t(perm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = slice(3, 40)
    want_batch, got_batch = jax_unpack(want[rows]), unpack(got[rows])
    for k in ("actions", "values", "returns", "advantages", "log_probs", "mu", "sigma"):
        np.testing.assert_array_equal(got_batch[k].numpy(), np.asarray(want_batch[k]), err_msg=k)
    for k in ("policy", "aux"):
        np.testing.assert_array_equal(got_batch["obs"][k].numpy(), np.asarray(want_batch["obs"][k]), err_msg=k)

    stacked = tree_map(lambda x: torch.stack([_t(x), _t(x) * 2]), fields)
    perms = torch.stack([_t(perm), _t(perm[::-1].copy())])
    got2, _ = pack_minibatch_rows(Rollout(**stacked), _t(np.stack([returns] * 2)),
                                  _t(np.stack([advantages] * 2)), perms)
    np.testing.assert_array_equal(got2[0].numpy(), got.numpy())
    one, _ = pack_minibatch_rows(Rollout(**tree_map(lambda x: x[1], stacked)), _t(returns), _t(advantages), perms[1])
    np.testing.assert_array_equal(got2[1].numpy(), one.numpy())


def test_collect_window_matches_jax():
    """A feedforward window with no time-out, the JAX action noise replayed."""
    jenv, jppo, ts0, cs0 = _jax_setup(max_episode_length=1000, randomize=False)
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(jenv, T))(ts0, cs0)
    assert not np.asarray(rollout.dones).any()

    policy = _port_policy(cs0.obs, ts0.policy)
    ppo = PPO(policy, **PPO_KW)
    env = NLinkPendulum(N, LINKS, max_episode_length=1000, device="cpu")
    st = cs0.env_state
    cs = CollectState(
        env_state=NLinkState(_t(st.episode_length), _t(st.theta), _t(st.omega), env_keys(0, N)),
        obs={k: _t(v) for k, v in cs0.obs.items()}, carry=policy.initial_carry(N),
        stats=init_episode_stats(N, "cpu"),
    )
    noise = (np.asarray(rollout.actions) - np.asarray(rollout.mu)) / np.asarray(rollout.sigma)
    cs, got, _ = ppo.collect(env, cs, T, action_noise=torch.tensor(noise))
    assert got.carry0 == () and cs.carry == ()
    for name in ("actions", "rewards", "values", "log_probs", "mu", "sigma"):
        _close(getattr(got, name), getattr(rollout, name), 1e-4, 1e-5, name)
    _close(got.obs["policy"], rollout.obs["policy"], 1e-4, 1e-5, "obs")
    for role in ("actor", "critic"):
        for k in ("mean", "var", "count"):
            _close(getattr(getattr(policy, f"norm_{role}"), k), getattr(ts1.policy.norm[role], k), 1e-5, 1e-6,
                   f"norm {role} {k}")


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_update_matches_jax(mode):
    """One full update (GAE, 2 epochs x 4 minibatches of shuffled rows,
    adaptive-KL lr, global-norm clip, Adam) on a JAX-made rollout with
    dones, with the JAX update's permutation: losses and every updated
    parameter at rtol 3e-4 / atol 3e-5 (bf16 trunks: 5e-2 / 3e-2)."""
    jdt, tdt = DTYPES[mode]
    jenv, jppo, ts0, cs0 = _jax_setup(max_episode_length=5, randomize=True, dtype=jdt)
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(jenv, T))(ts0, cs0)
    assert np.asarray(rollout.dones).any()
    ts2, _, um = jax.jit(jppo.make_update_fn())(ts1, cs1, rollout)

    policy = _port_policy(cs1.obs, ts1.policy, tdt)
    ppo = PPO(policy, **PPO_KW)
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()}, carry=(), stats=None)
    _, metrics = ppo.update(cs, _port_rollout(rollout), perm=_t(_jax_perm(ts1.rng, T * N)))

    rtol, atol = BARS[mode]
    um = jax.device_get(um)
    assert set(metrics) == set(um)
    for k in um:
        _close(metrics[k], um[k], rtol, atol, f"metric {k}")
    want = _port_policy(cs1.obs, ts2.policy, tdt)
    for (name, got_p), (_, want_p) in zip(policy.named_parameters(), want.named_parameters()):
        _close(got_p, want_p.detach(), rtol, atol, f"updated {name}")


def _jax_stacked_setup():
    env = JaxNLink(N, LINKS, max_episode_length=5)
    _, obs = env.reset(jax.random.PRNGKey(0))
    ppo = JaxPPO(JaxAC(obs, GROUPS, env.num_actions, **POLICY_KW), **PPO_KW)
    init, _ = jax_make_multiseed_train(ppo, env, T, G)
    ts, cs = init(jax.random.PRNGKey(1))
    keys = jax.random.split(jax.random.PRNGKey(2), G)
    cs = cs.replace(env_state=jax.vmap(env.randomize_episode_length)(cs.env_state, keys))
    return env, ppo, ts, cs


def test_stacked_update_matches_vmapped_jax():
    """One update of G feedforward seeds, each with its own rows' permutation,
    equals ``jax.vmap(update)``: every per-seed loss, every updated parameter
    of every seed and the learning rates at rtol 3e-4 / atol 3e-5."""
    jenv, jppo, ts0, cs0 = _jax_stacked_setup()
    ts1, cs1, rollout, _ = jax.jit(jax.vmap(jppo.make_collect_fn(jenv, T)))(ts0, cs0)
    ts2, _, um = jax.jit(jax.vmap(jppo.make_update_fn()))(ts1, cs1, rollout)
    perms = jax.vmap(lambda k: _jax_perm(k, T * N))(ts1.rng)

    template = _port_policy({k: v[0] for k, v in cs1.obs.items()}, jax.tree_util.tree_map(lambda x: x[0], ts1.policy))
    ppo = PPO(template, **PPO_KW)

    def stacked(policy_state):
        ts = ppo.init_stacked_state([copy.deepcopy(template) for _ in range(G)])
        from_jax_stacked_state(jax.device_get(policy_state.params), _norm_np(policy_state.norm), template, ts)
        return ts

    ts = stacked(ts1.policy)
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()}, carry=(), stats=None)
    ts, _, metrics = ppo.update_stacked(ts, cs, _port_rollout(rollout), perm=_t(perms))

    um = jax.device_get(um)
    assert set(metrics) == set(um)
    for k in um:
        assert metrics[k].shape == (G,), k
        _close(metrics[k], um[k], 3e-4, 3e-5, f"metric {k}")
    want = stacked(ts2.policy)
    for name, got_p in ts.params.items():
        _close(got_p, want.params[name], 3e-4, 3e-5, f"updated {name}")
    _close(ts.lr, ts2.lr, 1e-6, 0.0, "lr")


CFG = {
    "num_steps_per_env": T,
    "seed": 3,
    "obs_groups": GROUPS,
    "policy": {"class_name": "ActorCritic", **POLICY_KW},
    "algorithm": {"class_name": "PPO", **PPO_KW},
}


def test_each_seed_equals_its_standalone_run():
    """Seed i of a stacked feedforward run (collect, then update with seed
    i's permutation) over 2 iterations with dones equals a single-seed run
    from seed i's rows of the stacked state: losses and final parameters."""
    env = NLinkPendulum(N, LINKS, max_episode_length=6, device="cpu")
    runner = MultiSeedRunner(env, copy.deepcopy(CFG), G, device="cpu")
    alg, ts, cs = runner.alg, runner.train_state, runner.collect_state
    cs.env_state.episode_length = torch.randint(0, 6, (G * N,), generator=torch.Generator().manual_seed(4),
                                                dtype=torch.int32)
    start_ts, start_cs = copy.deepcopy(ts), copy.deepcopy(cs)
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn(2, G, T, N, LINKS, generator=gen)
    perms = torch.stack([torch.stack([torch.randperm(T * N, generator=gen) for _ in range(G)]) for _ in range(2)])
    batched = []
    for it in range(2):
        cs, rollout, cm = alg.collect_stacked(env, ts, cs, T, action_noise=noise[it])
        ts, cs, um = alg.update_stacked(ts, cs, rollout, perm=perms[it])
        batched.append({**cm, **um})
    assert any(float(m["ep_count"][i]) > 0 for m in batched for i in range(G)), "want dones"

    for i in range(G):
        policy = copy.deepcopy(alg.policy)
        with torch.no_grad():
            for name, p in policy.named_parameters():
                p.copy_(start_ts.params[name][i])
            for name, b in policy.named_buffers():
                b.copy_(start_ts.buffers[name][i])
        ppo = PPO(policy, **PPO_KW)
        rows = slice(i * N, (i + 1) * N)
        single = CollectState(
            env_state=NLinkState(**{k: v[rows] for k, v in vars(start_cs.env_state).items()}),
            obs=tree_map(lambda x: x[i], start_cs.obs), carry=(),
            stats=EpisodeStats(*(x[i] for x in vars(start_cs.stats).values())))
        for it in range(2):
            single, rollout, cm = ppo.collect(env, single, T, action_noise=noise[it, i])
            single, um = ppo.update(single, rollout, perm=perms[it, i])
            for k, v in {**cm, **um}.items():
                _close(batched[it][k][i], v, 1e-4, 1e-5, f"seed {i} iteration {it} {k}")
        for name, p in policy.named_parameters():
            _close(ts.params[name][i], p, 1e-4, 1e-5, f"seed {i} {name}")


def test_feedforward_runners_train():
    """``OnPolicyRunner`` and ``MultiSeedRunner`` train the feedforward
    headline's policy (bf16 trunks) to finite losses; the permutation comes
    from the algorithm's generator, so two runs of one config agree."""
    cfg = copy.deepcopy(CFG)
    cfg["policy"]["dtype"] = torch.bfloat16
    from rsl_rl_tpu_torch.runners import OnPolicyRunner

    runs = []
    for _ in range(2):
        runner = OnPolicyRunner(NLinkPendulum(N, LINKS, max_episode_length=6, device="cpu"), copy.deepcopy(cfg),
                                device="cpu")
        runner.learn(2)
        runs.append(runner.history[-1]["metrics"])
    assert all(np.isfinite(v) for v in runs[0].values())
    assert runs[0] == runs[1]
    multi = MultiSeedRunner(NLinkPendulum(N, LINKS, max_episode_length=6, device="cpu"), copy.deepcopy(cfg), 3,
                            device="cpu")
    multi.learn(2)
    metrics = multi.history[-1]["metrics"]
    assert all(v.shape == (3,) and np.isfinite(v).all() for v in metrics.values())
    assert len({float(x) for x in metrics["Loss/surrogate"]}) == 3


def test_parity_protocol_tracks_jax_with_its_streams():
    """The feedforward NLink parity protocol's config
    (``benchmarks/parity_pendulum.py``'s ``train_cfg``: 64 envs of 5 links,
    [128, 128], 5 epochs x 4 minibatches, adaptive KL) with 30-step episodes,
    one single-seed run, the port driven by the JAX runner's random streams
    (action noise, permutations, reset draws;
    ``tests/torch_port_stream_parity.py``) against the JAX runner itself over
    4 iterations, three episode resets among them: every metric of every
    iteration at rtol 3e-4 / atol 3e-5 (one update's bar)."""
    from tests.torch_port_stream_parity import stream_run

    iterations = 4
    curve, history, jax_runner = stream_run(1, iterations, max_episode_length=30)
    ts, cs = jax_runner.train_state, jax_runner.collect_state
    for it in range(iterations):
        ts, cs, rollout, cm = jax_runner._collect(ts, cs)
        ts, cs, um = jax_runner._update(ts, cs, rollout)
        want = jax.device_get({**cm, **um})
        assert set(history[it]) == set(want)
        for k, v in want.items():
            _close(history[it][k], v, 3e-4, 3e-5, f"iteration {it} {k}")
    assert sum(h["ep_count"] for h in history) == 3 * 64 and all(np.isfinite(c) for c in curve[1:])
