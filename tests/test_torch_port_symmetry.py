"""The port's symmetry augmentation (``modules/symmetry.py`` and PPO's
symmetry hooks) against the JAX package, from the same weights and inputs.

JAX runs on the CPU. Both updates take the same JAX-made ``PointMass``
rollout (and, feedforward, the permutation the JAX update draws from its
key); each side mirrors with its own ``point_mass_symmetry``. One update in
each mode: data augmentation (the policy replays the original and the
mirrored copy in one batch), mirror loss (the actor replays the mirrored
obs on its own, with gradients) and logging only (that replay without
gradients).

Tolerances: the augmentation helpers exactly (they move data); a replay at
rtol 1e-5 / atol 1e-6; one update at rtol 3e-4 / atol 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.env import PointMass as JaxPointMass
from rsl_rl_tpu.env.toy import point_mass_symmetry as jax_point_mass_symmetry
from rsl_rl_tpu.modules import ActorCritic as JaxAC
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu.modules import symmetry as jsym
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState
from rsl_rl_tpu_torch.env import PointMass
from rsl_rl_tpu_torch.env.toy import point_mass_symmetry
from rsl_rl_tpu_torch.modules import ActorCritic, ActorCriticRecurrent, symmetry
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils.resolvers import string_to_callable
from rsl_rl_tpu_torch.utils.weights import from_jax_state

N, HID, T = 16, 16, 8
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
MLP_KW = dict(actor_hidden_dims=[16, 16], critic_hidden_dims=[16, 16], actor_obs_normalization=True,
              critic_obs_normalization=True)
POLICIES = {"feedforward": (JaxAC, ActorCritic, MLP_KW),
            "gru": (JaxACR, ActorCriticRecurrent, dict(MLP_KW, rnn_type="gru", rnn_hidden_dim=HID))}
MODES = {"augmentation": (True, False), "mirror": (False, True), "logging": (False, False)}
PPO_KW = dict(num_learning_epochs=2, num_mini_batches=2)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _sym_cfg(mode, fn):
    aug, mirror = MODES[mode]
    return {"use_data_augmentation": aug, "use_mirror_loss": mirror, "data_augmentation_func": fn,
            "mirror_loss_coeff": 0.5, "_env": None}


# ------------------------------------------------------------ the helpers


@pytest.mark.parametrize("time_major", [False, True], ids=["feedforward", "time_major"])
def test_augmentation_helpers_match_jax(time_major):
    """``apply_augmentation`` (obs and actions, each alone), ``tile_batch``
    and ``tile_carry`` give the JAX arrays exactly: copy-major, copy 0 the
    original, folded back onto the env axis when time-major."""
    rng = np.random.default_rng(0)
    lead = (5, 6) if time_major else (7,)
    obs = {"policy": rng.normal(size=(*lead, 2)).astype(np.float32),
           "privileged": rng.normal(size=(*lead, 3)).astype(np.float32)}
    actions = rng.normal(size=(*lead, 1)).astype(np.float32)
    jobs, jact = {k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(actions)
    tobs, tact = {k: _t(v) for k, v in obs.items()}, _t(actions)
    for o, a, jo, ja in ((tobs, tact, jobs, jact), (tobs, None, jobs, None), (None, tact, None, jact)):
        want = jsym.apply_augmentation(jax_point_mass_symmetry, None, jo, ja, time_major)
        got = symmetry.apply_augmentation(point_mass_symmetry, None, o, a, time_major)
        assert got[2] == want[2] == 2
        if o is not None:
            for k in obs:
                np.testing.assert_array_equal(got[0][k].numpy(), np.asarray(want[0][k]))
        if a is not None:
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    x = rng.normal(size=lead).astype(np.float32)
    np.testing.assert_array_equal(symmetry.tile_batch(_t(x), 3, time_major).numpy(),
                                  np.asarray(jsym.tile_batch(jnp.asarray(x), 3, time_major)))
    carry = {"actor": (rng.normal(size=(6, 4)).astype(np.float32),),
             "critic": ((rng.normal(size=(6, 4)).astype(np.float32), rng.normal(size=(6, 4)).astype(np.float32)),)}
    want = jax.tree_util.tree_leaves(jsym.tile_carry(jax.tree_util.tree_map(jnp.asarray, carry), 2))
    got = jax.tree_util.tree_leaves(symmetry.tile_carry(tree_map(_t, carry), 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_config_resolution():
    """``resolve_symmetry_config`` copies the config and adds the env; a
    ``"module:attr"`` string resolves to the port's function, and a
    non-callable one raises."""
    cfg = {"symmetry_cfg": {"use_data_augmentation": True}}
    out = symmetry.resolve_symmetry_config(dict(cfg), "env")
    assert out["symmetry_cfg"]["_env"] == "env" and "_env" not in cfg["symmetry_cfg"]
    assert string_to_callable("rsl_rl_tpu_torch.env.toy:point_mass_symmetry") is point_mass_symmetry
    with pytest.raises(ValueError, match="not callable"):
        string_to_callable("rsl_rl_tpu_torch.modules.rnd:NORM_UNTIL")
    with pytest.raises(ValueError, match="module:attribute"):
        string_to_callable("rsl_rl_tpu_torch.env.toy.point_mass_symmetry")


# ---------------------------------------------------------------- updates


def _jax_setup(name, mode):
    env = JaxPointMass(N, max_episode_length=5)
    _, obs = env.reset(jax.random.PRNGKey(0))
    jcls, _, kw = POLICIES[name]
    ppo = JaxPPO(jcls(obs, GROUPS, env.num_actions, **kw), symmetry_cfg=_sym_cfg(mode, jax_point_mass_symmetry),
                 **PPO_KW)
    ts = ppo.init_train_state(jax.random.PRNGKey(1), N)
    cs = ppo.init_collect_state(jax.random.PRNGKey(2), env)
    cs = cs.replace(env_state=env.randomize_episode_length(cs.env_state, jax.random.PRNGKey(3)))
    return env, ppo, ts, cs


def _port_policy(name, obs, ps):
    _, cls, kw = POLICIES[name]
    policy = cls({k: _t(v) for k, v in obs.items()}, GROUPS, 1, device="cpu", **kw)
    ps = jax.device_get(ps)
    from_jax_state(ps.params, {k: None if v is None else {f: np.asarray(getattr(v, f)) for f in ("mean", "var", "count")}
                               for k, v in ps.norm.items()}, policy)
    return policy


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_update_matches_jax(name, mode):
    """One update (2 epochs x 2 minibatches) in each symmetry mode on a
    JAX-made window with dones: every metric (``Loss/symmetry`` included)
    and every updated parameter (JAX ``tests/test_symmetry.py:192``'s
    recurrent mirror-loss mode among them)."""
    jenv, jppo, ts0, cs0 = _jax_setup(name, mode)
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(jenv, T))(ts0, cs0)
    assert np.asarray(rollout.dones).any()
    ts2, _, um = jax.jit(jppo.make_update_fn())(ts1, cs1, rollout)

    policy = _port_policy(name, cs1.obs, ts1.policy)
    ppo = PPO(policy, symmetry_cfg=_sym_cfg(mode, "rsl_rl_tpu_torch.env.toy:point_mass_symmetry"), **PPO_KW)
    recurrent = policy.is_recurrent
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()},
                      carry=tree_map(_t, jax.device_get(cs1.carry)), stats=None)
    port_rollout = Rollout(
        obs={k: _t(v) for k, v in rollout.obs.items()}, actions=_t(rollout.actions), rewards=_t(rollout.rewards),
        dones=_t(rollout.dones), values=_t(rollout.values), log_probs=_t(rollout.log_probs), mu=_t(rollout.mu),
        sigma=_t(rollout.sigma), carry0=tree_map(_t, jax.device_get(rollout.carry0)) if recurrent else ())
    perm = None if recurrent else _t(jax.random.permutation(jax.random.split(ts1.rng)[1], T * N))
    _, metrics = ppo.update(cs, port_rollout, perm=perm)

    um = jax.device_get(um)
    assert set(metrics) == set(um) and "Loss/symmetry" in um
    for k in um:
        _close(metrics[k], um[k], 3e-4, 3e-5, f"metric {k}")
    want = _port_policy(name, cs1.obs, ts2.policy)
    for (n, got_p), (_, want_p) in zip(policy.named_parameters(), want.named_parameters()):
        _close(got_p, want_p.detach(), 3e-4, 3e-5, f"updated {n}")


def test_recurrent_augmented_replay_matches_manual_tiling():
    """The augmented recurrent replay sees the mirrored obs with the same
    window-start carry and resets as the original: its first copy equals
    the replay of the original window (JAX ``tests/test_symmetry.py:229``)."""
    cfg = {"num_steps_per_env": T, "save_interval": 100, "seed": 1, "obs_groups": GROUPS,
           "policy": {"class_name": "ActorCriticRecurrent", **POLICIES["gru"][2]},
           "algorithm": {"class_name": "PPO", "symmetry_cfg": _sym_cfg("augmentation", point_mass_symmetry)}}
    runner = OnPolicyRunner(PointMass(8, max_episode_length=5, device="cpu"), cfg, device="cpu")
    policy = runner.alg.policy
    _, rollout, _ = runner.alg.collect(runner.env, runner.collect_state, T)
    assert rollout.dones.any()
    obs_a, _, num_aug = symmetry.apply_augmentation(point_mass_symmetry, None, rollout.obs, None, True)
    resets = rollout.replay_resets()
    with torch.no_grad():
        mean_full, _ = policy.act_seq(obs_a, symmetry.tile_carry(rollout.carry0, num_aug),
                                      symmetry.tile_batch(resets, num_aug, True))
        mean_orig, _ = policy.act_seq(rollout.obs, rollout.carry0, resets)
        mean_mirror, _ = policy.act_seq({k: -v for k, v in rollout.obs.items()}, rollout.carry0, resets)
    _close(mean_full[:, :8], mean_orig, 1e-5, 1e-6, "original copy")
    _close(mean_full[:, 8:], mean_mirror, 1e-5, 1e-6, "mirrored copy")


def test_logging_mode_takes_no_gradient_through_the_mirror():
    """In logging-only mode the update equals an update without symmetry:
    the mirror replay adds a metric and no gradient."""
    runs = []
    for sym in (_sym_cfg("logging", point_mass_symmetry), None):
        cfg = {"num_steps_per_env": T, "save_interval": 100, "seed": 1, "obs_groups": GROUPS,
               "policy": {"class_name": "ActorCriticRecurrent", **POLICIES["gru"][2]},
               "algorithm": {"class_name": "PPO", "symmetry_cfg": sym, **PPO_KW}}
        runner = OnPolicyRunner(PointMass(8, max_episode_length=5, device="cpu"), cfg, device="cpu")
        runner.learn(2)
        runs.append(runner)
    for a, b in zip(runs[0].alg.policy.parameters(), runs[1].alg.policy.parameters()):
        assert torch.equal(a, b)
    assert "Loss/symmetry" in runs[0].history[-1]["metrics"] and "Loss/symmetry" not in runs[1].history[-1]["metrics"]
