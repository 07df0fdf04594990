"""The port's RND (``modules/rnd.py``, the reward normalizer of
``ops/running_norm.py`` and PPO's RND hooks) against the JAX package, from
the same weights and inputs.

JAX runs on the CPU. Random streams differ between the frameworks, so the
collect test replays the JAX action noise and the update test feeds both the
same JAX-made rollout; the RND state (predictor, target, both normalizers,
counter) is carried across with ``utils/weights.py`` ``from_jax_rnd_state``.

Tolerances: the normalizers, rewards and weights at rtol 1e-5 / atol 1e-6
(fp32 in another order); the predictor loss's gradient at rtol 2e-4 / atol
2e-5; a collection window at rtol 1e-4 / atol 1e-5 (the test of the same
window without RND); one update at rtol 3e-4 / atol 3e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu.modules.rnd import RandomNetworkDistillation as JaxRND
from rsl_rl_tpu.ops import running_norm as jnorm
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState
from rsl_rl_tpu_torch.env import NLinkPendulum, Pendulum, PointMass
from rsl_rl_tpu_torch.env.nlink import NLinkState, env_keys
from rsl_rl_tpu_torch.modules import ActorCriticRecurrent
from rsl_rl_tpu_torch.modules.rnd import RandomNetworkDistillation
from rsl_rl_tpu_torch.ops import running_norm
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils.weights import from_jax_rnd_state, from_jax_state

N, LINKS, HID, T = 16, 3, 16, 8
GROUPS = {"policy": ["policy"], "critic": ["policy"], "rnd_state": ["policy"]}
POLICY_KW = dict(rnn_type="gru", rnn_hidden_dim=HID, actor_hidden_dims=[16, 16], critic_hidden_dims=[16, 16],
                 actor_obs_normalization=True, critic_obs_normalization=True)
PPO_KW = dict(num_learning_epochs=2, num_mini_batches=2)
RND_KW = dict(num_outputs=4, predictor_hidden_dims=[-1, 8], target_hidden_dims=[-1], state_normalization=True,
              reward_normalization=True)
SCHEDULES = {
    "constant": {"mode": "constant"},
    "step": {"mode": "step", "final_step": 12, "final_value": 0.1},
    "linear": {"mode": "linear", "initial_step": 4, "final_step": 20, "final_value": 2.0},
}


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _norm_np(norm):
    return None if norm is None else {k: np.asarray(getattr(norm, k)) for k in ("mean", "var", "count")}


def _rnd_np(state):
    state = jax.device_get(state)
    reward = None if state.reward_norm is None else {**_norm_np(state.reward_norm.emp),
                                                     "avg": np.asarray(state.reward_norm.avg)}
    return {"predictor": state.predictor, "target": state.target, "state_norm": _norm_np(state.state_norm),
            "reward_norm": reward, "counter": state.counter}


def _check_rnd_state(rnd, state, rtol, atol, what):
    want = _rnd_np(state)
    assert int(rnd.counter) == int(want["counter"]), f"{what} counter"
    for name, got, ref in (("state_norm", rnd.state_norm, want["state_norm"]),
                           ("reward_norm", None if rnd.reward_norm is None else rnd.reward_norm.emp,
                            want["reward_norm"])):
        assert (got is None) == (ref is None)
        for k in () if got is None else ("mean", "var", "count"):
            _close(getattr(got, k), ref[k], rtol, atol, f"{what} {name} {k}")
    if rnd.reward_norm is not None:
        _close(rnd.reward_norm.avg, want["reward_norm"]["avg"], rtol, atol, f"{what} reward accumulator")


# ------------------------------------------------------------- the parts


@pytest.mark.parametrize("until", [None, 1e8, 50.0], ids=["never", "reference", "freeze_at_50"])
def test_normalize_reward_matches_jax(until):
    """A random reward stream through the discounted-variation normalizer:
    the accumulator, the scalar moments and the scaled reward each step
    (the first step divides by a zero std, which it must skip)."""
    rng = np.random.default_rng(0)
    jstate = jnorm.init_discounted_variation_norm(N, until=until)
    state = running_norm.DiscountedVariationNormState(N, until=until)
    for step in range(12):
        rew = rng.normal(loc=0.5, scale=2.0, size=N).astype(np.float32)
        jstate, want = jnorm.normalize_reward(jstate, jnp.asarray(rew))
        got = running_norm.normalize_reward(state, _t(rew))
        _close(got, want, 1e-5, 1e-6, f"step {step} scaled reward")
        _close(state.avg, jstate.avg, 1e-5, 1e-6, f"step {step} avg")
        for k in ("mean", "var", "count"):
            _close(getattr(state.emp, k), getattr(jstate.emp, k), 1e-5, 1e-6, f"step {step} {k}")
    jstate, want = jnorm.normalize_reward(jstate, jnp.ones(N), update=False)
    _close(running_norm.normalize_reward(state, torch.ones(N), update=False), want, 1e-5, 1e-6, "no update")
    _close(state.emp.count, jstate.emp.count, 0, 0, "count after a read")


def _rnd_pair(schedule=None, state_normalization=True, reward_normalization=True, weight=0.7):
    kw = dict(RND_KW, state_normalization=state_normalization, reward_normalization=reward_normalization,
              weight=weight, weight_schedule=schedule)
    jrnd = JaxRND(num_states=6, obs_groups=GROUPS, **kw)
    jstate = jrnd.init(jax.random.PRNGKey(3), N)
    rnd = RandomNetworkDistillation(num_states=6, obs_groups=GROUPS, **kw)
    rnd.init_reward_norm(N)
    from_jax_rnd_state(_rnd_np(jstate), rnd)
    return jrnd, jstate, rnd


@pytest.mark.parametrize("state_norm,reward_norm", [(True, True), (False, False), (True, False)],
                         ids=["both_norms", "no_norms", "state_norm_only"])
def test_intrinsic_reward_and_predictor_loss_match_jax(state_norm, reward_norm):
    """Steps of ``update_normalization`` + ``get_intrinsic_reward`` on
    random obs (reward, weight, counter, both normalizers), then the
    predictor loss and its gradient in the predictor's parameters."""
    jrnd, jstate, rnd = _rnd_pair(state_normalization=state_norm, reward_normalization=reward_norm)
    rng = np.random.default_rng(1)
    for step in range(6):
        obs = rng.normal(loc=1.0, scale=2.0, size=(N, 6)).astype(np.float32)
        jstate = jrnd.update_normalization(jstate, {"policy": jnp.asarray(obs)})
        jstate, jrew, jweight = jrnd.get_intrinsic_reward(jstate, {"policy": jnp.asarray(obs)})
        rnd.update_normalization({"policy": _t(obs)})
        rew, weight = rnd.get_intrinsic_reward({"policy": _t(obs)})
        _close(rew, jrew, 1e-5, 1e-6, f"step {step} intrinsic reward")
        _close(weight, jweight, 1e-6, 1e-7, f"step {step} weight")
        _check_rnd_state(rnd, jstate, 1e-5, 1e-6, f"step {step}")
    obs = rng.normal(size=(T, N, 6)).astype(np.float32)
    jloss, jgrad = jax.value_and_grad(jrnd.predictor_loss)(jstate.predictor, jstate, {"policy": jnp.asarray(obs)})
    loss = rnd.predictor_loss({"policy": _t(obs)})
    _close(loss, jloss, 1e-5, 1e-6, "predictor loss")
    grads = torch.autograd.grad(loss, list(rnd.predictor.parameters()))
    jgrad = jax.device_get(jgrad)
    for (name, _), g in zip(rnd.predictor.named_parameters(), grads):
        layer, kind = name.split(".")
        want = jgrad[layer]["kernel"].T if kind == "weight" else jgrad[layer]["bias"]
        _close(g, want, 2e-4, 2e-5, f"grad {name}")
    assert all(p.grad is None for p in rnd.target.parameters()) and not any(
        p.requires_grad for p in rnd.target.parameters())


@pytest.mark.parametrize("mode", sorted(SCHEDULES))
def test_weight_schedule_matches_jax(mode):
    jrnd, _, rnd = _rnd_pair(SCHEDULES[mode])
    for counter in (0, 3, 4, 11, 12, 13, 20, 40):
        c = jnp.asarray(counter, jnp.int32)
        _close(rnd.current_weight(torch.tensor(counter, dtype=torch.int32)), jrnd.current_weight(c), 1e-6, 1e-7,
               f"{mode} weight at {counter}")


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="schedule"):
        RandomNetworkDistillation(num_states=6, obs_groups=GROUPS, weight_schedule={"mode": "cosine"}, **RND_KW)


# --------------------------------------------------------- PPO with RND


def _jax_setup(max_episode_length, randomize):
    env = JaxNLink(N, LINKS, max_episode_length=max_episode_length)
    _, obs = env.reset(jax.random.PRNGKey(0))
    policy = JaxACR(obs, GROUPS, env.num_actions, **POLICY_KW)
    rnd_cfg = dict(RND_KW, num_states=3 * LINKS, obs_groups=GROUPS, weight=0.5 * env.step_dt,
                   weight_schedule=SCHEDULES["linear"], learning_rate=3e-3)
    ppo = JaxPPO(policy, rnd_cfg=rnd_cfg, **PPO_KW)
    ts = ppo.init_train_state(jax.random.PRNGKey(1), N)
    cs = ppo.init_collect_state(jax.random.PRNGKey(2), env)
    if randomize:
        cs = cs.replace(env_state=env.randomize_episode_length(cs.env_state, jax.random.PRNGKey(3)))
    return env, ppo, ts, cs, rnd_cfg


def _port_ppo(obs, ts, rnd_cfg):
    policy = ActorCriticRecurrent({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS, device="cpu", **POLICY_KW)
    ps = jax.device_get(ts.policy)
    from_jax_state(ps.params, {k: _norm_np(v) for k, v in ps.norm.items()}, policy)
    ppo = PPO(policy, rnd_cfg=rnd_cfg, **PPO_KW)
    ppo.rnd.init_reward_norm(N)
    from_jax_rnd_state(_rnd_np(ts.rnd), ppo.rnd)
    return ppo


def test_recurrent_rnd_collect_matches_jax():
    """A window with no time-out, the JAX action noise replayed: the
    rewards (extrinsic + intrinsic), the per-env extrinsic and intrinsic
    episode sums, the RND state after the window and the logged weight."""
    jenv, jppo, ts0, cs0, rnd_cfg = _jax_setup(max_episode_length=1000, randomize=False)
    ts1, cs1, rollout, cm = jax.jit(jppo.make_collect_fn(jenv, T))(ts0, cs0)
    assert not np.asarray(rollout.dones).any()

    ppo = _port_ppo(cs0.obs, ts0, rnd_cfg)
    env = NLinkPendulum(N, LINKS, max_episode_length=1000, device="cpu")
    st = cs0.env_state
    cs = ppo.init_collect_state(NLinkState(_t(st.episode_length), _t(st.theta), _t(st.omega), env_keys(0, N)),
                                {k: _t(v) for k, v in cs0.obs.items()}, N)
    from_jax_rnd_state(_rnd_np(ts0.rnd), ppo.rnd)  # init_collect_state made a fresh reward normalizer
    noise = (np.asarray(rollout.actions) - np.asarray(rollout.mu)) / np.asarray(rollout.sigma)
    cs, got, metrics = ppo.collect(env, cs, T, action_noise=torch.tensor(noise))

    _close(got.rewards, rollout.rewards, 1e-4, 1e-5, "rewards")
    for f in ("cur_reward_sum", "cur_ereward_sum", "cur_ireward_sum"):
        _close(getattr(cs.stats, f), getattr(cs1.stats, f), 1e-4, 1e-5, f)
    assert float(np.abs(np.asarray(cs1.stats.cur_ireward_sum)).max()) > 0
    _check_rnd_state(ppo.rnd, ts1.rnd, 1e-4, 1e-5, "after the window")
    _close(metrics["Rnd/weight"], cm["Rnd/weight"], 1e-6, 1e-7, "Rnd/weight")
    assert set(metrics) == set(jax.device_get(cm))


def test_recurrent_rnd_update_matches_jax():
    """One update (2 epochs x 2 minibatches) with RND on a JAX-made window
    with dones: every metric (``Loss/rnd`` included), every updated policy
    parameter, and the predictor after its own Adam steps; the target and
    the normalizers stay as they were."""
    jenv, jppo, ts0, cs0, rnd_cfg = _jax_setup(max_episode_length=5, randomize=True)
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(jenv, T))(ts0, cs0)
    assert np.asarray(rollout.dones).any()
    ts2, _, um = jax.jit(jppo.make_update_fn())(ts1, cs1, rollout)

    ppo = _port_ppo(cs1.obs, ts1, rnd_cfg)
    target0 = [p.clone() for p in ppo.rnd.target.parameters()]
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()},
                      carry=tree_map(_t, jax.device_get(cs1.carry)), stats=None)
    port_rollout = Rollout(
        obs={k: _t(v) for k, v in rollout.obs.items()}, actions=_t(rollout.actions), rewards=_t(rollout.rewards),
        dones=_t(rollout.dones), values=_t(rollout.values), log_probs=_t(rollout.log_probs), mu=_t(rollout.mu),
        sigma=_t(rollout.sigma), carry0=tree_map(_t, jax.device_get(rollout.carry0)))
    _, metrics = ppo.update(cs, port_rollout)

    um = jax.device_get(um)
    assert set(metrics) == set(um) and "Loss/rnd" in um
    for k in um:
        _close(metrics[k], um[k], 3e-4, 3e-5, f"metric {k}")
    want = _port_ppo(cs1.obs, ts2, rnd_cfg)
    for (name, got_p), (_, want_p) in zip(ppo.policy.named_parameters(), want.policy.named_parameters()):
        _close(got_p, want_p.detach(), 3e-4, 3e-5, f"updated {name}")
    for (name, got_p), (_, want_p) in zip(ppo.rnd.predictor.named_parameters(), want.rnd.predictor.named_parameters()):
        _close(got_p, want_p.detach(), 3e-4, 3e-5, f"updated predictor {name}")
    assert all(torch.equal(a, b) for a, b in zip(target0, ppo.rnd.target.parameters()))
    assert int(ppo.rnd_optimizer.adam_count) == 4
    _check_rnd_state(ppo.rnd, ts2.rnd, 0, 0, "after the update")


# --------------------------------------------------------------- runner


def _runner_cfg(rnd=True, **keys):
    cfg = {"num_steps_per_env": 4, "save_interval": 100, "seed": 1,
           "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
           "policy": {"class_name": "ActorCriticRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 8,
                      "actor_hidden_dims": [8], "critic_hidden_dims": [8], "actor_obs_normalization": True},
           "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2}, **keys}
    if rnd:
        cfg["obs_groups"]["rnd_state"] = ["policy"]
        cfg["algorithm"]["rnd_cfg"] = {"weight": 1.0, "predictor_hidden_dims": [8], "target_hidden_dims": [8],
                                       "num_outputs": 4, "state_normalization": True, "reward_normalization": True}
    return cfg


def test_rnd_weight_not_compounded_across_runners():
    """Two runners from one config template scale the weight by ``step_dt``
    once each; the template is not changed (JAX
    ``test_rnd_weight_not_compounded_across_runners``)."""
    template = _runner_cfg()
    r1 = OnPolicyRunner(PointMass(4, device="cpu"), template, device="cpu")
    r2 = OnPolicyRunner(PointMass(4, device="cpu"), template, device="cpu")
    assert template["algorithm"]["rnd_cfg"]["weight"] == 1.0 and "num_states" not in template["algorithm"]["rnd_cfg"]
    assert np.isclose(r1.alg.rnd.initial_weight, PointMass.dt) and np.isclose(r2.alg.rnd.initial_weight, PointMass.dt)


def test_rnd_state_set_defaults_to_policy():
    """Without an ``rnd_state`` obs set the runner takes the policy's, as the
    JAX runner does."""
    cfg = _runner_cfg()
    del cfg["obs_groups"]["rnd_state"]
    with pytest.warns(UserWarning, match="rnd_state"):
        runner = OnPolicyRunner(Pendulum(4, device="cpu"), cfg, device="cpu")
    assert runner.cfg["obs_groups"]["rnd_state"] == ["policy"] and runner.alg.rnd.num_states == 3


def test_rnd_resume_requires_rnd_state(tmp_path):
    """Resuming an RND run from a checkpoint without RND state raises (JAX
    ``test_rnd_resume_requires_rnd_state``)."""
    plain = OnPolicyRunner(Pendulum(4, device="cpu"), _runner_cfg(rnd=False), device="cpu")
    path = str(tmp_path / "plain.pt")
    plain.save(path)
    runner = OnPolicyRunner(Pendulum(4, device="cpu"), _runner_cfg(), device="cpu")
    with pytest.raises(ValueError, match="no RND state"):
        runner.load(path)


def test_rnd_resume_restores_rnd_and_trains_identically(tmp_path):
    """A run saved after 2 iterations and resumed into a fresh runner holds
    the RND state and its optimizer's state bit for bit and then trains as
    the uninterrupted run does."""
    a = OnPolicyRunner(Pendulum(4, device="cpu"), _runner_cfg(), device="cpu")
    a.learn(2)
    path = str(tmp_path / "model_1.pt")
    a.save(path)
    b = OnPolicyRunner(Pendulum(4, device="cpu"), _runner_cfg(), device="cpu")
    b.load(path)
    b.collect_state = copy.deepcopy(a.collect_state)
    b.alg.generator.set_state(a.alg.generator.get_state())
    for x, y in zip(a.alg.rnd.state_dict().values(), b.alg.rnd.state_dict().values()):
        assert torch.equal(x, y)
    assert int(b.alg.rnd_optimizer.adam_count) == int(a.alg.rnd_optimizer.adam_count) > 0
    a.learn(1)
    b.learn(1)
    for x, y in zip([*a.alg.rnd.state_dict().values(), *a.alg.rnd_optimizer.adam_nu],
                    [*b.alg.rnd.state_dict().values(), *b.alg.rnd_optimizer.adam_nu]):
        assert torch.equal(x, y)
    assert a.history[-1]["metrics"] == b.history[-1]["metrics"]


def test_rnd_metrics_and_writer_keys():
    """An RND run logs ``Rnd/weight``, ``Loss/rnd`` and the extrinsic and
    intrinsic episode sums, and writes the JAX runner's RND scalars."""
    runner = OnPolicyRunner(Pendulum(4, max_episode_length=3, device="cpu"), _runner_cfg(), device="cpu")
    tags = set()
    runner.writer = type("W", (), {"add_scalar": lambda self, tag, *a: tags.add(tag), "flush": lambda self: None})()
    runner.learn(2)
    metrics = runner.history[-1]["metrics"]
    assert {"Rnd/weight", "Loss/rnd", "ep_ereward_sum", "ep_ireward_sum"} <= set(metrics)
    assert metrics["ep_ireward_sum"] != 0.0
    assert {"Rnd/weight", "Rnd/mean_extrinsic_reward", "Rnd/mean_intrinsic_reward", "Loss/rnd"} <= tags
