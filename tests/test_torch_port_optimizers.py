"""The port's optimizers (``adam``, ``adamw``, ``sgd``, ``rmsprop``;
``utils/resolvers.py`` ``resolve_optimizer`` and ``algorithms/ppo.py``
``clip_step``) against the optax chains the JAX package builds, alone and
inside one PPO update and one distillation update.

JAX runs on the CPU; both updates take the same JAX-made window. The stacked
(multi-seed) update takes the same optimizer under ``torch.func.vmap``:
each seed equals its own single-seed update.

Tolerances: the optimizer steps at rtol 1e-6 / atol 1e-7 (elementwise fp32
in the same order); one update at rtol 3e-4 / atol 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rsl_rl_tpu.algorithms.distillation import Distillation as JaxDistillation
from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.env.nlink import DomainRandomizedNLink as JaxDRNLink
from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu.modules import StudentTeacherRecurrent as JaxSTR
from rsl_rl_tpu.utils.resolvers import resolve_optimizer as jax_resolve_optimizer
from rsl_rl_tpu_torch.algorithms.distillation import Distillation
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState, clip_step
from rsl_rl_tpu_torch.env import NLinkPendulum
from rsl_rl_tpu_torch.modules import ActorCriticRecurrent, StudentTeacherRecurrent
from rsl_rl_tpu_torch.runners import MultiSeedRunner
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils.resolvers import resolve_optimizer
from rsl_rl_tpu_torch.utils.weights import from_jax_state

OPTIMIZERS = ["adamw", "sgd", "rmsprop"]
N, LINKS, HID, T = 16, 3, 16, 8


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _norm_np(norm):
    return None if norm is None else {k: np.asarray(getattr(norm, k)) for k in ("mean", "var", "count")}


@pytest.mark.parametrize("name", ["adam", *OPTIMIZERS])
@pytest.mark.parametrize("max_grad_norm", [None, 0.5], ids=["no_clip", "clip"])
def test_clip_step_matches_optax_chain(name, max_grad_norm):
    """Three steps of ``clip_by_global_norm`` -> the optimizer's direction
    -> ``p - lr * u`` at a learning rate that changes between steps."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    direction = jax_resolve_optimizer(name)()
    tx = direction if max_grad_norm is None else optax.chain(optax.clip_by_global_norm(max_grad_norm), direction)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jparams)
    tparams = [_t(params[k]) for k in shapes]
    mu, nu = [torch.zeros(s) for s in shapes.values()], [torch.zeros(s) for s in shapes.values()]
    count = torch.zeros((), dtype=torch.int32)
    for step, lr in enumerate((0.1, 0.05, 0.2)):
        grads = {k: 2.0 * rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        updates, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p - lr * u, jparams, updates)
        tparams, mu, nu, count = clip_step(tparams, [_t(grads[k]) for k in shapes], mu, nu, count,
                                           torch.tensor(lr), max_grad_norm, direction=resolve_optimizer(name))
        for k, p in zip(shapes, tparams):
            _close(p, jparams[k], 1e-6, 1e-7, f"{name} step {step} {k}")
    assert int(count) == 3


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Valid optimizers"):
        resolve_optimizer("lamb")


def _port_rollout(rollout, carry0):
    fields = {k: _t(getattr(rollout, k)) for k in ("actions", "rewards", "dones", "values", "log_probs", "mu", "sigma")
              if getattr(rollout, k, None) is not None}
    return Rollout(obs={k: _t(v) for k, v in rollout.obs.items()}, carry0=carry0, **fields)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_ppo_update_matches_jax(name):
    """One recurrent PPO update (2 epochs x 2 minibatches, adaptive-KL rate,
    global-norm clip) with the optimizer: every metric and every updated
    parameter."""
    groups = {"policy": ["policy"], "critic": ["policy"]}
    kw = dict(rnn_type="gru", rnn_hidden_dim=HID, actor_hidden_dims=[16], critic_hidden_dims=[16],
              actor_obs_normalization=True, critic_obs_normalization=True)
    alg_kw = dict(num_learning_epochs=2, num_mini_batches=2, optimizer=name)
    env = JaxNLink(N, LINKS, max_episode_length=5)
    _, obs = env.reset(jax.random.PRNGKey(0))
    jppo = JaxPPO(JaxACR(obs, groups, LINKS, **kw), **alg_kw)
    ts0 = jppo.init_train_state(jax.random.PRNGKey(1), N)
    cs0 = jppo.init_collect_state(jax.random.PRNGKey(2), env)
    cs0 = cs0.replace(env_state=env.randomize_episode_length(cs0.env_state, jax.random.PRNGKey(3)))
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(env, T))(ts0, cs0)
    ts2, _, um = jax.jit(jppo.make_update_fn())(ts1, cs1, rollout)

    def port_policy(ps):
        policy = ActorCriticRecurrent({k: _t(v) for k, v in cs1.obs.items()}, groups, LINKS, device="cpu", **kw)
        ps = jax.device_get(ps)
        from_jax_state(ps.params, {k: _norm_np(v) for k, v in ps.norm.items()}, policy)
        return policy

    ppo = PPO(port_policy(ts1.policy), **alg_kw)
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()},
                      carry=tree_map(_t, jax.device_get(cs1.carry)), stats=None)
    _, metrics = ppo.update(cs, _port_rollout(rollout, tree_map(_t, jax.device_get(rollout.carry0))))
    um = jax.device_get(um)
    assert set(metrics) == set(um)
    for k in um:
        _close(metrics[k], um[k], 3e-4, 3e-5, f"{name} metric {k}")
    for (n, got), (_, want) in zip(ppo.policy.named_parameters(), port_policy(ts2.policy).named_parameters()):
        _close(got, want.detach(), 3e-4, 3e-5, f"{name} updated {n}")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_distillation_update_matches_jax(name):
    """One distillation update of a GRU student (2 epochs of an 8-step
    window in segments of 5, the masked clip) with the optimizer: the
    logged loss and every updated student parameter."""
    groups = {"policy": ["policy"], "teacher": ["privileged"]}
    kw = dict(rnn_type="gru", rnn_hidden_dim=HID, student_hidden_dims=[16], teacher_hidden_dims=[16],
              student_obs_normalization=True, teacher_obs_normalization=True)
    alg_kw = dict(num_learning_epochs=2, gradient_length=5, max_grad_norm=0.05, learning_rate=1e-2, optimizer=name)
    env = JaxDRNLink(N, LINKS, max_episode_length=6)
    _, obs = env.reset(jax.random.PRNGKey(0))
    jalg = JaxDistillation(JaxSTR(obs, groups, LINKS, **kw), **alg_kw)
    ts0 = jalg.init_train_state(jax.random.PRNGKey(1), N)
    cs0 = jalg.init_collect_state(jax.random.PRNGKey(2), env)
    ts1, cs1, rollout, _ = jax.jit(jalg.make_collect_fn(env, T))(ts0, cs0)
    ts2, _, um = jax.jit(jalg.make_update_fn())(ts1, cs1, rollout)

    def port_policy(ps):
        policy = StudentTeacherRecurrent({k: _t(v) for k, v in cs1.obs.items()}, groups, LINKS, device="cpu", **kw)
        ps = jax.device_get(ps)
        aux = {"teacher": ps.aux["teacher"], "teacher_norm": _norm_np(ps.aux["teacher_norm"])}
        from_jax_state(ps.params, {"student": _norm_np(ps.norm["student"])}, policy, aux)
        return policy

    alg = Distillation(port_policy(ts1.policy), **alg_kw)
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()},
                      carry=tree_map(_t, jax.device_get(cs1.carry)), stats=None)
    port_rollout = Rollout(obs={k: _t(v) for k, v in rollout.obs.items()}, actions=_t(rollout.actions),
                           rewards=_t(rollout.rewards), dones=_t(rollout.dones),
                           privileged_actions=_t(rollout.privileged_actions),
                           carry0=tree_map(_t, jax.device_get(rollout.carry0)))
    _, metrics = alg.update(cs, port_rollout)
    _close(metrics["Loss/behavior"], um["Loss/behavior"], 3e-4, 3e-5, f"{name} Loss/behavior")
    for (n, got), (_, want) in zip(alg.policy.named_parameters(), port_policy(ts2.policy).named_parameters()):
        _close(got, want.detach(), 3e-4, 3e-5, f"{name} updated {n}")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_stacked_update_takes_the_optimizer(name):
    """A study of 2 seeds with the optimizer trains each seed's moments: the
    second moments are nonzero where the optimizer keeps them (adamw,
    rmsprop) and the first where it keeps one (adamw); sgd keeps neither."""
    cfg = {"num_steps_per_env": 4, "save_interval": 100, "seed": 3,
           "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
           "policy": {"class_name": "ActorCriticRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 8,
                      "actor_hidden_dims": [8], "critic_hidden_dims": [8]},
           "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2, "optimizer": name}}
    runner = MultiSeedRunner(NLinkPendulum(8, LINKS, device="cpu"), cfg, 2, device="cpu")
    runner.learn(1)
    ts = runner.train_state
    mu_used = any(float(v.abs().max()) > 0 for v in ts.adam_mu.values())
    nu_used = any(float(v.abs().max()) > 0 for v in ts.adam_nu.values())
    assert (mu_used, nu_used) == {"adamw": (True, True), "sgd": (False, False), "rmsprop": (False, True)}[name]
    assert ts.adam_count.tolist() == [2, 2]
    for k in ("Loss/surrogate", "Loss/value_function"):
        assert np.isfinite(runner.history[-1]["metrics"][k]).all()
