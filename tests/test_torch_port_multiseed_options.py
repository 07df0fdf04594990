"""The port's multi-seed training with PPO's options (stacked RND and
symmetry, ``PPO.collect_stacked`` / ``PPO.update_stacked``) against
``jax.vmap`` of the JAX package's collect and update, each seed against its
own single-seed port run, and the study's RND checkpoints and ``save_seed``.

JAX runs on the CPU. Random streams differ between the frameworks, so the
collect test feeds the port the JAX rollout's action noise and the update
tests feed both the same JAX-made rollout; the seeds' weights and RND states
are carried across with ``utils/weights.py``.

Tolerances: a collection window at rtol 1e-4 / atol 1e-5 and an update at
rtol 3e-4 / atol 3e-5 (the bars of the single-seed RND and symmetry tests
and of the stacked update without options).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.env import PointMass as JaxPointMass
from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu.env.toy import point_mass_symmetry as jax_point_mass_symmetry
from rsl_rl_tpu.modules import ActorCritic as JaxAC
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu.runners.multiseed import make_multiseed_train as jax_make_multiseed_train
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState, EpisodeStats
from rsl_rl_tpu_torch.env import NLinkPendulum, Pendulum, PointMass
from rsl_rl_tpu_torch.env.nlink import NLinkState, env_keys
from rsl_rl_tpu_torch.modules import ActorCritic, ActorCriticRecurrent
from rsl_rl_tpu_torch.runners import MultiSeedRunner, OnPolicyRunner, make_multiseed_train
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils.weights import from_jax_stacked_rnd_state, from_jax_stacked_state

G, N, LINKS, HID, T = 2, 16, 3, 16, 8
GROUPS = {"policy": ["policy"], "critic": ["policy"], "rnd_state": ["policy"]}
MLP_KW = dict(actor_hidden_dims=[16, 16], critic_hidden_dims=[16, 16], actor_obs_normalization=True,
              critic_obs_normalization=True)
GRU_KW = dict(MLP_KW, rnn_type="gru", rnn_hidden_dim=HID)
PPO_KW = dict(num_learning_epochs=2, num_mini_batches=2)
RND_KW = dict(num_outputs=4, predictor_hidden_dims=[-1, 8], target_hidden_dims=[-1], state_normalization=True,
              reward_normalization=True, weight_schedule={"mode": "linear", "initial_step": 4, "final_step": 20,
                                                          "final_value": 2.0}, learning_rate=3e-3)
SYM_MODES = {"augmentation": (True, False), "mirror": (False, True), "logging": (False, False)}
PORT_SYM_FN = "rsl_rl_tpu_torch.env.toy:point_mass_symmetry"


def _t(x):
    return torch.tensor(np.asarray(x))


def _tree_t(tree):
    return tree_map(_t, jax.device_get(tree))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _norm_np(norm):
    return {k: None if v is None else {f: np.asarray(getattr(v, f)) for f in ("mean", "var", "count")}
            for k, v in norm.items()}


def _rnd_np(state):
    state = jax.device_get(state)

    def moments(n):
        return None if n is None else {k: np.asarray(getattr(n, k)) for k in ("mean", "var", "count")}

    reward = None if state.reward_norm is None else {**moments(state.reward_norm.emp),
                                                     "avg": np.asarray(state.reward_norm.avg)}
    return {"predictor": state.predictor, "target": state.target, "state_norm": moments(state.state_norm),
            "reward_norm": reward, "counter": state.counter}


def _port_rollout(rollout, recurrent=True):
    return Rollout(
        obs={k: _t(v) for k, v in rollout.obs.items()}, actions=_t(rollout.actions), rewards=_t(rollout.rewards),
        dones=_t(rollout.dones), values=_t(rollout.values), log_probs=_t(rollout.log_probs), mu=_t(rollout.mu),
        sigma=_t(rollout.sigma), carry0=_tree_t(rollout.carry0) if recurrent else ())


# ------------------------------------------------------------ stacked RND


def _jax_rnd_setup(max_episode_length, randomize):
    env = JaxNLink(N, LINKS, max_episode_length=max_episode_length)
    _, obs = env.reset(jax.random.PRNGKey(0))
    rnd_cfg = dict(RND_KW, num_states=3 * LINKS, obs_groups=GROUPS, weight=0.5 * env.step_dt)
    ppo = JaxPPO(JaxACR(obs, GROUPS, env.num_actions, **GRU_KW), rnd_cfg=rnd_cfg, **PPO_KW)
    init, _ = jax_make_multiseed_train(ppo, env, T, G)
    ts, cs = init(jax.random.PRNGKey(1))
    if randomize:
        keys = jax.random.split(jax.random.PRNGKey(2), G)
        cs = cs.replace(env_state=jax.vmap(env.randomize_episode_length)(cs.env_state, keys))
    return env, ppo, ts, cs, rnd_cfg


def _port_rnd_stacked(obs, jts, rnd_cfg):
    """A port PPO with RND and a stacked state holding the JAX seeds' policy
    weights and RND states."""
    template = ActorCriticRecurrent({k: _t(v[0]) for k, v in obs.items()}, GROUPS, LINKS, device="cpu", **GRU_KW)
    ppo = PPO(template, rnd_cfg=rnd_cfg, **PPO_KW)
    ts = ppo.init_stacked_state([copy.deepcopy(template) for _ in range(G)], N)
    from_jax_stacked_state(jax.device_get(jts.policy.params), _norm_np(jts.policy.norm), template, ts)
    from_jax_stacked_rnd_state(_rnd_np(jts.rnd), ppo.rnd, ts)
    return ppo, ts


def test_stacked_rnd_collect_matches_vmapped_jax():
    """A multi-seed window with RND (no time-out in it), each seed's action
    noise injected: the rewards (extrinsic + intrinsic), the per-seed RND
    state after the window (both normalizers, the accumulator, the counter),
    ``Rnd/weight`` and the intrinsic episode sums."""
    jenv, jppo, ts0, cs0, rnd_cfg = _jax_rnd_setup(max_episode_length=1000, randomize=False)
    ts1, cs1, rollout, cm = jax.jit(jax.vmap(jppo.make_collect_fn(jenv, T)))(ts0, cs0)
    assert not np.asarray(rollout.dones).any()

    ppo, ts = _port_rnd_stacked(cs0.obs, ts0, rnd_cfg)
    env = NLinkPendulum(N, LINKS, max_episode_length=1000, device="cpu")
    st = jax.device_get(cs0.env_state)
    flat = [_t(x).reshape(G * N, *np.shape(x)[2:]) for x in (st.episode_length, st.theta, st.omega)]
    cs = ppo.init_stacked_collect_state(NLinkState(*flat, env_keys(0, G * N)),
                                        {k: _t(v) for k, v in cs0.obs.items()}, G)
    noise = (np.asarray(rollout.actions) - np.asarray(rollout.mu)) / np.asarray(rollout.sigma)
    cs, got, metrics = ppo.collect_stacked(env, ts, cs, T, action_noise=torch.tensor(noise))

    _close(got.rewards, rollout.rewards, 1e-4, 1e-5, "rewards")
    _close(cs.stats.cur_ireward_sum, cs1.stats.cur_ireward_sum, 1e-4, 1e-5, "intrinsic sums")
    assert float(np.abs(np.asarray(cs1.stats.cur_ireward_sum)).max()) > 0
    _close(metrics["Rnd/weight"], cm["Rnd/weight"], 1e-6, 1e-7, "Rnd/weight")
    assert set(metrics) == set(jax.device_get(cm))
    _, want = _port_rnd_stacked(cs1.obs, ts1, rnd_cfg)
    for name, v in want.rnd_buffers.items():
        _close(ts.rnd_buffers[name], v, 1e-4, 1e-5, f"RND {name} after the window")


def test_stacked_rnd_update_matches_vmapped_jax():
    """One multi-seed update with RND on a JAX-made window with per-seed
    desynchronized dones: every per-seed metric (``Loss/rnd`` included),
    every policy parameter, each seed's predictor after its own Adam steps
    and its step count; the targets and the normalizers stay."""
    jenv, jppo, ts0, cs0, rnd_cfg = _jax_rnd_setup(max_episode_length=5, randomize=True)
    ts1, cs1, rollout, _ = jax.jit(jax.vmap(jppo.make_collect_fn(jenv, T)))(ts0, cs0)
    dones = np.asarray(rollout.dones)
    assert dones.any() and not (dones[0] == dones[1]).all()
    ts2, _, um = jax.jit(jax.vmap(jppo.make_update_fn()))(ts1, cs1, rollout)

    ppo, ts = _port_rnd_stacked(cs1.obs, ts1, rnd_cfg)
    before = {k: v.clone() for k, v in {**ts.rnd_buffers, **{k: v for k, v in ts.rnd_params.items()
                                                              if k.startswith("target.")}}.items()}
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()}, carry=_tree_t(cs1.carry),
                      stats=None)
    ts, _, metrics = ppo.update_stacked(ts, cs, _port_rollout(rollout))

    um = jax.device_get(um)
    assert set(metrics) == set(um) and "Loss/rnd" in um
    for k in um:
        assert metrics[k].shape == (G,), k
        _close(metrics[k], um[k], 3e-4, 3e-5, f"metric {k}")
    _, want = _port_rnd_stacked(cs1.obs, ts2, rnd_cfg)
    for name, p in ts.params.items():
        _close(p, want.params[name], 3e-4, 3e-5, f"updated {name}")
    for name, p in ts.rnd_params.items():
        _close(p, want.rnd_params[name], 3e-4, 3e-5, f"updated RND {name}")
    for name, v in before.items():
        got = ts.rnd_buffers.get(name, ts.rnd_params.get(name))
        assert torch.equal(got, v), name
    assert ts.rnd_count.tolist() == [4] * G


# ------------------------------------------------------- stacked symmetry


def _sym_cfg(mode, fn):
    aug, mirror = SYM_MODES[mode]
    return {"use_data_augmentation": aug, "use_mirror_loss": mirror, "data_augmentation_func": fn,
            "mirror_loss_coeff": 0.5, "_env": None}


POLICIES = {"feedforward": (JaxAC, ActorCritic, MLP_KW), "gru": (JaxACR, ActorCriticRecurrent, GRU_KW)}
SYM_GROUPS = {"policy": ["policy"], "critic": ["policy"]}


@pytest.mark.parametrize("name,mode", [("gru", "augmentation"), ("gru", "mirror"), ("gru", "logging"),
                                       ("feedforward", "mirror")])
def test_stacked_symmetry_update_matches_vmapped_jax(name, mode):
    """One multi-seed update in each symmetry mode on a JAX-made
    ``PointMass`` window with dones: every per-seed metric
    (``Loss/symmetry`` included) and every updated parameter. The augmented
    batch replays all seeds' actor and critic memories in one call, the
    mirror loss the seeds' actors in another; each seed normalizes its
    advantages from its original part."""
    jcls, cls, kw = POLICIES[name]
    env = JaxPointMass(N, max_episode_length=5)
    _, obs = env.reset(jax.random.PRNGKey(0))
    jppo = JaxPPO(jcls(obs, SYM_GROUPS, env.num_actions, **kw),
                  symmetry_cfg=_sym_cfg(mode, jax_point_mass_symmetry), normalize_advantage_per_mini_batch=True,
                  **PPO_KW)
    init, _ = jax_make_multiseed_train(jppo, env, T, G)
    ts0, cs0 = init(jax.random.PRNGKey(1))
    keys = jax.random.split(jax.random.PRNGKey(2), G)
    cs0 = cs0.replace(env_state=jax.vmap(env.randomize_episode_length)(cs0.env_state, keys))
    ts1, cs1, rollout, _ = jax.jit(jax.vmap(jppo.make_collect_fn(env, T)))(ts0, cs0)
    assert np.asarray(rollout.dones).any()
    ts2, _, um = jax.jit(jax.vmap(jppo.make_update_fn()))(ts1, cs1, rollout)

    template = cls({k: _t(v[0]) for k, v in cs1.obs.items()}, SYM_GROUPS, 1, device="cpu", **kw)
    ppo = PPO(template, symmetry_cfg=_sym_cfg(mode, PORT_SYM_FN), normalize_advantage_per_mini_batch=True, **PPO_KW)
    ts = ppo.init_stacked_state([copy.deepcopy(template) for _ in range(G)], N)
    from_jax_stacked_state(jax.device_get(ts1.policy.params), _norm_np(ts1.policy.norm), template, ts)
    recurrent = template.is_recurrent
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()},
                      carry=_tree_t(cs1.carry) if recurrent else (), stats=None)
    perm = None
    if not recurrent:  # each seed's permutation, drawn from its key as the JAX update does
        perm = torch.stack([_t(jax.random.permutation(jax.random.split(k)[1], T * N)) for k in ts1.rng])
    ts, _, metrics = ppo.update_stacked(ts, cs, _port_rollout(rollout, recurrent), perm=perm)

    um = jax.device_get(um)
    assert set(metrics) == set(um) and "Loss/symmetry" in um
    for k in um:
        _close(metrics[k], um[k], 3e-4, 3e-5, f"metric {k}")
    want = ppo.init_stacked_state([copy.deepcopy(template) for _ in range(G)], N)
    from_jax_stacked_state(jax.device_get(ts2.policy.params), _norm_np(ts2.policy.norm), template, want)
    for n, p in ts.params.items():
        _close(p, want.params[n], 3e-4, 3e-5, f"updated {n}")


# ------------------------------------------ each seed against its own run


def _study_cfg(option):
    cfg = {"num_steps_per_env": T, "seed": 3, "save_interval": 2,
           "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
           "policy": {"class_name": "ActorCriticRecurrent", **GRU_KW},
           "algorithm": {"class_name": "PPO", **PPO_KW}}
    if option == "rnd":
        cfg["obs_groups"]["rnd_state"] = ["policy"]
        cfg["algorithm"]["rnd_cfg"] = {k: v for k, v in RND_KW.items()} | {"weight": 1.0}
    else:
        cfg["algorithm"]["symmetry_cfg"] = _sym_cfg(option, PORT_SYM_FN)
    return cfg


def _study_env(option):
    return Pendulum(N, max_episode_length=6, device="cpu") if option == "rnd" else \
        PointMass(N, max_episode_length=6, device="cpu")


@pytest.mark.parametrize("option", ["rnd", "augmentation", "mirror"])
def test_each_seed_equals_its_standalone_run(option):
    """Seed i of a G-seed run with RND or symmetry equals a single-seed port
    run from seed i's rows of the stacked state (its RND module included)
    over 2 iterations with dones: every metric, every policy parameter and
    the RND predictor."""
    cfg = _study_cfg(option)
    runner = MultiSeedRunner(_study_env(option), copy.deepcopy(cfg), G, device="cpu")
    alg, ts, cs = runner.alg, runner.train_state, runner.collect_state
    cs.env_state.episode_length = torch.randint(0, 6, (G * N,), generator=torch.Generator().manual_seed(4),
                                                dtype=torch.int32)
    start_ts, start_cs = copy.deepcopy(ts), copy.deepcopy(cs)
    A = runner.env.num_actions
    noise = torch.randn(2, G, T, N, A, generator=torch.Generator().manual_seed(5))
    _, step = make_multiseed_train(alg, runner.env, T, G, device="cpu")
    ts_b, cs_b = ts, cs
    batched = []
    for it in range(2):
        ts_b, cs_b, m = step(ts_b, cs_b, action_noise=noise[it])
        batched.append(m)
    assert any(float(m["ep_count"][i]) > 0 for m in batched for i in range(G)), "want dones"

    for i in range(G):
        single_runner = OnPolicyRunner(_study_env(option), copy.deepcopy(cfg), device="cpu")
        ppo = single_runner.alg
        with torch.no_grad():
            for name, p in ppo.policy.named_parameters():
                p.copy_(start_ts.params[name][i])
            for name, b in ppo.policy.named_buffers():
                b.copy_(start_ts.buffers[name][i])
        pick = lambda tree: tree_map(lambda t: t[i], tree)  # noqa: E731
        rows = slice(i * N, (i + 1) * N)
        env_state = type(start_cs.env_state)(**{k: v[rows] for k, v in vars(start_cs.env_state).items()})
        single = CollectState(env_state=env_state, obs=pick(start_cs.obs), carry=pick(start_cs.carry),
                              stats=EpisodeStats(*(x[i] for x in vars(start_cs.stats).values())))
        if ppo.rnd is not None:
            ppo.init_collect_state(env_state, single.obs, N)  # sizes the reward normalizer
            with torch.no_grad():
                for name, p in ppo.rnd.named_parameters():
                    p.copy_(start_ts.rnd_params[name][i])
                for name, b in ppo.rnd.named_buffers():
                    b.copy_(start_ts.rnd_buffers[name][i])
        for it in range(2):
            single, rollout, cm = ppo.collect(single_runner.env, single, T, action_noise=noise[it, i])
            single, um = ppo.update(single, rollout)
            for k, v in {**cm, **um}.items():
                _close(batched[it][k][i], v, 1e-4, 1e-5, f"seed {i} iteration {it} {k}")
        for name, p in ppo.policy.named_parameters():
            _close(ts_b.params[name][i], p, 1e-4, 1e-5, f"seed {i} {name}")
        if ppo.rnd is not None:
            for name, p in ppo.rnd.predictor.named_parameters():
                _close(ts_b.rnd_params[f"predictor.{name}"][i], p, 1e-4, 1e-5, f"seed {i} predictor {name}")


# ----------------------------------------------------------- checkpoints


def test_rnd_study_resumes_and_refuses_a_mismatch(tmp_path):
    """A study with RND saves each seed's RND state and its optimizer; a
    fresh runner resumes it bit for bit and trains on as the original does.
    A checkpoint without RND state is refused by a study with RND, and one
    with it by a study without."""
    cfg = _study_cfg("rnd")
    a = MultiSeedRunner(_study_env("rnd"), copy.deepcopy(cfg), G, log_dir=None, device="cpu")
    a.learn(2)
    path = str(tmp_path / "study.pt")
    a.save(path)
    b = MultiSeedRunner(_study_env("rnd"), copy.deepcopy(cfg), G, device="cpu")
    b.load(path)
    for x, y in zip(a.train_state.seed_tensors(), b.train_state.seed_tensors()):
        assert torch.equal(x, y)
    assert a.train_state.rnd_count.tolist() == [8, 8]  # 2 iterations x 2 epochs x 2 minibatches
    b.collect_state = copy.deepcopy(a.collect_state)
    b.alg.generator.set_state(a.alg.generator.get_state())
    a.learn(1)
    b.learn(1)
    for x, y in zip(a.train_state.seed_tensors(), b.train_state.seed_tensors()):
        assert torch.equal(x, y)

    plain_cfg = _study_cfg("rnd")
    del plain_cfg["algorithm"]["rnd_cfg"], plain_cfg["obs_groups"]["rnd_state"]
    plain = MultiSeedRunner(_study_env("rnd"), plain_cfg, G, device="cpu")
    with pytest.raises(ValueError, match="RND"):
        plain.load(path)
    plain_path = str(tmp_path / "plain.pt")
    plain.save(plain_path)
    with pytest.raises(ValueError, match="RND"):
        b.load(plain_path)


@pytest.mark.parametrize("option", ["plain", "rnd"])
def test_save_seed_loads_into_on_policy_runner(tmp_path, option):
    """``save_seed`` writes one seed as the single-seed checkpoint that
    ``OnPolicyRunner.load`` takes: the policy, its optimizer state and
    learning rate, and with RND its RND state and predictor optimizer; the
    loaded runner's inference policy reproduces that seed's actions. An
    index out of range raises."""
    cfg = _study_cfg("rnd")
    if option == "plain":
        del cfg["algorithm"]["rnd_cfg"], cfg["obs_groups"]["rnd_state"]
    study = MultiSeedRunner(_study_env("rnd"), copy.deepcopy(cfg), G, device="cpu")
    study.learn(2)
    path = str(tmp_path / "seed1.pt")
    study.save_seed(path, 1)
    with pytest.raises(ValueError, match="out of range"):
        study.save_seed(path + "x", G)
    single = OnPolicyRunner(_study_env("rnd"), copy.deepcopy(cfg), device="cpu")
    single.load(path)
    ts = study.train_state
    for name, p in single.alg.policy.named_parameters():
        assert torch.equal(p, ts.params[name][1]), name
    assert torch.equal(single.alg.lr, ts.lr[1]) and int(single.alg.adam_count) == int(ts.adam_count[1])
    assert single.current_learning_iteration == study.current_learning_iteration
    if option == "rnd":
        for name, v in single.alg.rnd.state_dict().items():
            want = ts.rnd_params[name] if name in ts.rnd_params else ts.rnd_buffers[name]
            assert torch.equal(v, want[1]), name
        assert int(single.alg.rnd_optimizer.adam_count) == int(ts.rnd_count[1])
    obs = {k: v[1] for k, v in study.collect_state.obs.items()}
    carry = tree_map(lambda t: t[1], study.alg.policy.initial_carry(N))
    from torch.func import functional_call
    state = ({k: v[1] for k, v in ts.params.items()}, {k: v[1] for k, v in ts.buffers.items()})
    want, _ = functional_call(study.alg.policy, state, ("act_inference", obs, carry))
    got = single.get_inference_policy()(obs)
    assert torch.equal(got, want)
