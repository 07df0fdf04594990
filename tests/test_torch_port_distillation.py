"""The port's distillation (``StudentTeacher``, ``StudentTeacherRecurrent``,
``Distillation``, ``DistillationRunner``) against the JAX package, from the
same weights and inputs.

JAX runs on the CPU: its update replays the student through its scan path
there, and the student's window replay is also held against the JAX
package's Pallas kernels in interpret mode (the gate forced open, as
``tests/test_pallas_rnn.py`` does). The port runs its plain versions on the
CPU. Random streams differ between the frameworks, so the collect test
replays the JAX action noise (drawn again from the JAX keys) and the update
tests feed both the same JAX-made rollout.
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsl_rl_tpu.algorithms.distillation import Distillation as JaxDistillation
from rsl_rl_tpu.env.nlink import DomainRandomizedNLink as JaxDRNLink
from rsl_rl_tpu.modules import StudentTeacher as JaxST
from rsl_rl_tpu.modules import StudentTeacherRecurrent as JaxSTR
from rsl_rl_tpu.ops import pallas_rnn
from rsl_rl_tpu_torch.algorithms.distillation import Distillation, huber_loss
from rsl_rl_tpu_torch.algorithms.ppo import CollectState, clip_step, init_episode_stats
from rsl_rl_tpu_torch.env.nlink import DomainRandomizedNLink, DomainRandomizedNLinkState, env_keys
from rsl_rl_tpu_torch.modules import StudentTeacher, StudentTeacherRecurrent
from rsl_rl_tpu_torch.runners import DistillationRunner
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils.weights import from_jax_state

N, LINKS, HID, T = 8, 3, 16, 12
GROUPS = {"policy": ["policy"], "teacher": ["privileged"]}
MLP_KW = dict(student_hidden_dims=[16, 16], teacher_hidden_dims=[16, 16], student_obs_normalization=True,
              teacher_obs_normalization=True)
POLICIES = {
    "feedforward": MLP_KW,
    "gru": dict(MLP_KW, rnn_type="gru", rnn_hidden_dim=HID),
    "lstm": dict(MLP_KW, rnn_type="lstm", rnn_hidden_dim=HID),
    "gru_teacher_recurrent": dict(MLP_KW, rnn_type="gru", rnn_hidden_dim=HID, teacher_recurrent=True),
}
#: (policy, Distillation arguments): the cases of the JAX package's chunked
#: replay test (2 epochs of a 12-step window in segments of 5, the last 4
#: steps a forward-only tail; 1 epoch in segments of 7), both losses, the
#: masked clip at a norm that clips, and no clip
UPDATE_CASES = {
    "feedforward": ("feedforward", {}),
    "gru": ("gru", {}),
    "lstm": ("lstm", {}),
    "gru_teacher_recurrent": ("gru_teacher_recurrent", {}),
    "gru_epochs1_gradient_length7": ("gru", dict(num_learning_epochs=1, gradient_length=7)),
    "feedforward_huber": ("feedforward", dict(loss_type="huber")),
    "lstm_huber_no_clip": ("lstm", dict(loss_type="huber", max_grad_norm=None)),
}
ALG_KW = dict(num_learning_epochs=2, gradient_length=5, max_grad_norm=0.05, learning_rate=1e-2)


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _close_tree(got, want, rtol, atol, what):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, rtol, atol, f"{what}[{i}]")


def _norm(state):
    return None if state is None else {k: np.asarray(getattr(state, k)) for k in ("mean", "var", "count")}


def _jax_policy(name, obs, num_actions):
    cls = JaxST if name == "feedforward" else JaxSTR
    return cls(obs, GROUPS, num_actions, **POLICIES[name])


def _port_policy(name, obs, ps):
    cls = StudentTeacher if name == "feedforward" else StudentTeacherRecurrent
    policy = cls({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS, device="cpu", **POLICIES[name])
    aux = {"teacher": ps.aux["teacher"], "teacher_norm": _norm(ps.aux["teacher_norm"]),
           "memory_t": ps.aux.get("memory_t")}
    from_jax_state(jax.device_get(ps.params), {"student": _norm(ps.norm["student"])}, policy, jax.device_get(aux))
    return policy


def _jax_setup(name, max_episode_length, **alg_kw):
    env = JaxDRNLink(N, LINKS, max_episode_length=max_episode_length)
    _, obs = env.reset(jax.random.PRNGKey(0))
    alg = JaxDistillation(_jax_policy(name, obs, env.num_actions), **{**ALG_KW, **alg_kw})
    ts = alg.init_train_state(jax.random.PRNGKey(1), N)
    cs = alg.init_collect_state(jax.random.PRNGKey(2), env)
    cs = cs.replace(env_state=env.randomize_episode_length(cs.env_state, jax.random.PRNGKey(3)))
    return env, alg, ts, cs


def _random_carry(policy, rng):
    return tree_map(lambda t: torch.tensor(rng.normal(size=t.shape).astype(np.float32)), policy.initial_carry(N))


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_acting_matches_jax(name):
    """``act``, ``evaluate`` and ``act_inference`` from the same weights,
    normalizer moments and carry."""
    env = JaxDRNLink(N, LINKS)
    _, obs = env.reset(jax.random.PRNGKey(4))
    jpolicy = _jax_policy(name, obs, LINKS)
    ps = jpolicy.init(jax.random.PRNGKey(5))
    ps = jpolicy.update_normalization(ps, obs)
    policy = _port_policy(name, obs, ps)
    tobs = {k: _t(v) for k, v in obs.items()}
    carry = _random_carry(policy, np.random.default_rng(6))
    jcarry = tree_map(lambda t: jnp.asarray(t.numpy()), carry)
    want_mean, want_std, want_c = jpolicy.act(ps, obs, jcarry)
    want_teacher, want_ct = jpolicy.evaluate(ps, obs, jcarry)
    want_inf, _ = jpolicy.act_inference(ps, obs, jcarry)
    with torch.no_grad():
        mean, std, c = policy.act(tobs, carry)
        teacher, ct = policy.evaluate(tobs, carry)
        inf, _ = policy.act_inference(tobs, carry)
    for what, got, want in (("mean", mean, want_mean), ("std", std, want_std), ("teacher", teacher, want_teacher),
                            ("act_inference", inf, want_inf)):
        _close(got, want, 1e-5, 1e-5, what)
    _close_tree(c, want_c, 1e-5, 1e-5, "act carry")
    _close_tree(ct, want_ct, 1e-5, 1e-5, "evaluate carry")
    trained = {n for n, p in policy.named_parameters() if p.requires_grad}
    assert trained == {n for n, _ in policy.named_parameters() if not n.startswith(("teacher.", "memory_t."))}


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_student_seq_matches_pallas_interpret(rnn_type, monkeypatch):
    """The student's window replay (``student_seq``, through
    ``Memory.sequence_with_carry``) against the JAX student's replay through
    the Pallas kernels in interpret mode, at a shape the kernels' gate takes:
    actions, the carry after the window, and the gradients of every student
    parameter at the bars of tests/test_pallas_rnn.py (rtol 2e-4 / atol 2e-5)."""
    B, H, steps = 128, 128, 6
    rng = np.random.default_rng(7)
    obs = {"policy": rng.normal(size=(B, 3 * LINKS)).astype(np.float32),
           "privileged": rng.normal(size=(B, 4 * LINKS)).astype(np.float32)}
    kw = dict(POLICIES[rnn_type], rnn_hidden_dim=H)
    jpolicy = JaxSTR(jax.tree_util.tree_map(jnp.asarray, obs), GROUPS, LINKS, **kw)
    ps = jpolicy.init(jax.random.PRNGKey(8))
    ps = jpolicy.update_normalization(ps, obs)
    policy = StudentTeacherRecurrent({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS, device="cpu", **kw)
    aux = {"teacher": ps.aux["teacher"], "teacher_norm": _norm(ps.aux["teacher_norm"]), "memory_t": None}
    from_jax_state(jax.device_get(ps.params), {"student": _norm(ps.norm["student"])}, policy, jax.device_get(aux))
    seq = {"policy": rng.normal(size=(steps, B, 3 * LINKS)).astype(np.float32),
           "privileged": rng.normal(size=(steps, B, 4 * LINKS)).astype(np.float32)}
    resets = rng.random((steps, B)) < 0.15
    resets[0] = False
    carry0 = tree_map(lambda t: torch.tensor(rng.normal(size=t.shape).astype(np.float32)), policy.initial_carry(B))
    jcarry0 = tree_map(lambda t: jnp.asarray(t.numpy()), carry0)

    def jax_loss(params):
        actions, carry = jpolicy.student_seq(ps.replace(params=params), seq, jcarry0, jnp.asarray(resets))
        return jnp.sum(actions * jnp.cos(actions)), (actions, carry)

    monkeypatch.setattr(pallas_rnn, "supports_pallas_rnn", lambda *a, **k: True)
    with pltpu.force_tpu_interpret_mode():
        jgrads, (want, want_carry) = jax.grad(jax_loss, has_aux=True)(ps.params)
    actions, carry = policy.student_seq({k: _t(v) for k, v in seq.items()}, carry0, _t(resets))
    torch.sum(actions * torch.cos(actions)).backward()
    _close(actions, want, 2e-4, 2e-5, "actions")
    _close_tree(carry, want_carry, 2e-4, 2e-5, "carry after the window")
    ref = copy.deepcopy(policy)
    from_jax_state(jax.device_get(jgrads) | {"std": np.zeros(LINKS, np.float32)},
                   {"student": _norm(ps.norm["student"])}, ref, jax.device_get(aux))
    for (n, p), (_, g) in zip(policy.named_parameters(), ref.named_parameters()):
        if n.startswith(("student.", "memory_s.")):
            _close(p.grad, g, 2e-4, 2e-5, f"grad {n}")


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case):
    """One distillation update on a JAX-made window with desynchronized
    dones against JAX ``make_update_fn`` (its chunked replay): the logged
    loss, every updated student parameter and the acting carry after the
    replay at rtol 3e-4 / atol 3e-5."""
    name, alg_kw = UPDATE_CASES[case]
    jenv, jalg, ts0, cs0 = _jax_setup(name, max_episode_length=6, **alg_kw)
    ts1, cs1, rollout, _ = jax.jit(jalg.make_collect_fn(jenv, T))(ts0, cs0)
    dones = np.asarray(rollout.dones)
    assert dones.any() and not dones.all(axis=1).any(), "want desynchronized dones"
    ts2, cs2, um = jax.jit(jalg.make_update_fn())(ts1, cs1, rollout)

    policy = _port_policy(name, cs1.obs, ts1.policy)
    alg = Distillation(policy, **{**ALG_KW, **alg_kw})
    recurrent = policy.is_recurrent
    carry0 = tree_map(_t, jax.device_get(rollout.carry0)) if recurrent else ()
    port_rollout = Rollout(
        obs={k: _t(v) for k, v in rollout.obs.items()}, actions=_t(rollout.actions), rewards=_t(rollout.rewards),
        dones=_t(rollout.dones), privileged_actions=_t(rollout.privileged_actions), carry0=carry0)
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()},
                      carry=tree_map(_t, jax.device_get(cs1.carry)), stats=None)
    cs, metrics = alg.update(cs, port_rollout)

    _close(metrics["Loss/behavior"], um["Loss/behavior"], 3e-4, 3e-5, "Loss/behavior")
    want = _port_policy(name, cs1.obs, ts2.policy)
    for (n, got_p), (_, want_p) in zip(policy.named_parameters(), want.named_parameters()):
        _close(got_p, want_p, 3e-4, 3e-5, f"updated {n}")
    if recurrent:
        _close_tree(cs.carry, cs2.carry, 3e-4, 3e-5, "carry after the update")


@pytest.mark.parametrize("name", ["feedforward", "gru"])
def test_collect_window_matches_jax(name):
    """A distillation window with no time-out, the JAX action noise replayed:
    the student's sampled actions, the teacher's recorded actions, rewards,
    obs (privileged group included), the final carry, the student's
    normalizer moments and the logged noise std."""
    env = JaxDRNLink(N, LINKS, max_episode_length=1000)
    _, obs = env.reset(jax.random.PRNGKey(0))
    jalg = JaxDistillation(_jax_policy(name, obs, LINKS), **ALG_KW)
    ts0 = jalg.init_train_state(jax.random.PRNGKey(1), N)
    cs0 = jalg.init_collect_state(jax.random.PRNGKey(2), env)
    ts1, cs1, rollout, cm = jax.jit(jalg.make_collect_fn(env, T))(ts0, cs0)
    assert not np.asarray(rollout.dones).any()
    key, noise = ts0.rng, []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        noise.append(jax.random.normal(k_act, (N, LINKS)))

    policy = _port_policy(name, cs0.obs, ts0.policy)
    alg = Distillation(policy, **ALG_KW)
    port_env = DomainRandomizedNLink(N, LINKS, max_episode_length=1000, device="cpu")
    st = cs0.env_state
    state = DomainRandomizedNLinkState(episode_length=_t(st.episode_length), theta=_t(st.theta),
                                       omega=_t(st.omega), rng=env_keys(0, N), mass_scale=_t(st.mass_scale))
    cs = alg.init_collect_state(state, {k: _t(v) for k, v in cs0.obs.items()}, N)
    cs, got, metrics = alg.collect(port_env, cs, T, action_noise=_t(np.stack(noise)))

    for what in ("actions", "privileged_actions", "rewards"):
        _close(getattr(got, what), getattr(rollout, what), 1e-4, 1e-5, what)
    for k in ("policy", "privileged"):
        _close(got.obs[k], rollout.obs[k], 1e-4, 1e-5, f"obs {k}")
    _close(metrics["Policy/mean_noise_std"], cm["Policy/mean_noise_std"], 1e-6, 1e-7, "mean noise std")
    _close_tree(cs.carry, cs1.carry, 1e-4, 1e-5, "final carry")
    for k in ("mean", "var", "count"):
        _close(getattr(policy.norm_student, k), getattr(ts1.policy.norm["student"], k), 1e-5, 1e-6, f"norm {k}")


def test_masked_clip_matches_optax_masked():
    """``clip_step`` (Adam) with a clip mask equals optax's ``masked`` global-norm
    clip of the marked leaves followed by ``scale_by_adam`` on all, over two
    steps: the unmarked leaves are neither clipped nor counted in the norm."""
    rng = np.random.default_rng(9)
    names = ["student", "memory_s", "std"]
    params = {k: rng.normal(size=(4, 3)).astype(np.float32) for k in names}
    tx = optax.chain(optax.masked(optax.clip_by_global_norm(0.5), {k: k == "student" for k in names}),
                     optax.scale_by_adam())
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jparams)
    tparams = [_t(params[k]) for k in names]
    mu, nu, count = [torch.zeros(4, 3) for _ in names], [torch.zeros(4, 3) for _ in names], torch.zeros((), dtype=torch.int32)
    for step in range(2):
        grads = {k: 3.0 * rng.normal(size=(4, 3)).astype(np.float32) for k in names}
        updates, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p - 0.1 * u, jparams, updates)
        tparams, mu, nu, count = clip_step(tparams, [_t(grads[k]) for k in names], mu, nu, count,
                                           torch.tensor(0.1), 0.5, [k == "student" for k in names])
        for k, p in zip(names, tparams):
            _close(p, jparams[k], 1e-6, 1e-7, f"step {step} {k}")


def test_huber_matches_optax():
    rng = np.random.default_rng(10)
    a, b = (rng.normal(scale=2.0, size=(5, 7)).astype(np.float32) for _ in range(2))
    _close(huber_loss(_t(a), _t(b)), optax.huber_loss(jnp.asarray(a), jnp.asarray(b), delta=1.0), 1e-6, 1e-7, "huber")


def _runner_cfg(**policy):
    return {
        "num_steps_per_env": 4,
        "seed": 2,
        "obs_groups": {"policy": ["policy"]},
        "policy": {"class_name": "StudentTeacherRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 8,
                   "student_hidden_dims": [8], "teacher_hidden_dims": [8], **policy},
        "algorithm": {"class_name": "Distillation", "gradient_length": 2},
    }


def test_learn_requires_a_loaded_teacher():
    """``learn`` raises until a teacher is loaded; the ``teacher`` obs set
    defaults to the like-named group (here ``policy``'s copy: the env has
    none named ``teacher``)."""
    env = DomainRandomizedNLink(4, LINKS, device="cpu")
    with pytest.warns(UserWarning, match="teacher"):
        runner = DistillationRunner(env, _runner_cfg(), device="cpu")
    assert runner.cfg["obs_groups"]["teacher"] == ["policy"]
    with pytest.raises(ValueError, match="Teacher model parameters not loaded"):
        runner.learn(1)


def test_entry_points_require_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    obs = {"policy": torch.zeros(4, 3 * LINKS), "privileged": torch.zeros(4, 4 * LINKS)}
    for make in (lambda: DomainRandomizedNLink(4, LINKS), lambda: StudentTeacher(obs, GROUPS, LINKS),
                 lambda: StudentTeacherRecurrent(obs, GROUPS, LINKS),
                 lambda: DistillationRunner(DomainRandomizedNLink(4, LINKS, device="cpu"), _runner_cfg())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_rnn_hidden_size_is_a_deprecated_alias():
    obs = {"policy": torch.zeros(4, 3 * LINKS), "privileged": torch.zeros(4, 4 * LINKS)}
    with pytest.warns(DeprecationWarning, match="rnn_hidden_size"):
        policy = StudentTeacherRecurrent(obs, GROUPS, LINKS, rnn_type="gru", rnn_hidden_size=12, device="cpu")
    assert policy.rnn_hidden_dim == 12 and policy.memory_s.hidden_size == 12
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        StudentTeacherRecurrent(obs, GROUPS, LINKS, rnn_type="gru", rnn_hidden_dim=12, device="cpu")
