"""The port's multi-seed distillation (``Distillation.collect_stacked`` /
``update_stacked``, ``MultiSeedRunner`` with a ``Distillation`` algorithm,
``MultiSeedRunner.load_teacher``) against ``jax.vmap`` of the JAX package's
update, and the study's teacher bootstrap.

JAX runs on the CPU. The update test feeds both sides the same JAX-made
window (per-seed desynchronized dones) from the same per-seed weights, the
JAX seeds' own random teachers included; tolerance rtol 3e-4 / atol 3e-5
(the single-seed distillation update's bar).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.distillation import Distillation as JaxDistillation
from rsl_rl_tpu.env.nlink import DomainRandomizedNLink as JaxDRNLink
from rsl_rl_tpu.modules import StudentTeacher as JaxST
from rsl_rl_tpu.modules import StudentTeacherRecurrent as JaxSTR
from rsl_rl_tpu.runners.multiseed import make_multiseed_train as jax_make_multiseed_train
from rsl_rl_tpu_torch.algorithms.distillation import Distillation
from rsl_rl_tpu_torch.algorithms.ppo import CollectState
from rsl_rl_tpu_torch.env import DomainRandomizedNLink
from rsl_rl_tpu_torch.modules import StudentTeacher, StudentTeacherRecurrent
from rsl_rl_tpu_torch.runners import DistillationRunner, MultiSeedRunner, OnPolicyRunner
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils.weights import from_jax_state

G, N, LINKS, HID, T = 2, 8, 3, 16, 12
GROUPS = {"policy": ["policy"], "teacher": ["privileged"]}
MLP_KW = dict(student_hidden_dims=[16, 16], teacher_hidden_dims=[16, 16], student_obs_normalization=True,
              teacher_obs_normalization=True)
POLICIES = {
    "feedforward": MLP_KW,
    "lstm": dict(MLP_KW, rnn_type="lstm", rnn_hidden_dim=HID),
    "gru_teacher_recurrent": dict(MLP_KW, rnn_type="gru", rnn_hidden_dim=HID, teacher_recurrent=True),
}
ALG_KW = dict(num_learning_epochs=2, gradient_length=5, max_grad_norm=0.05, learning_rate=1e-2)


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _norm(state):
    return None if state is None else {k: np.asarray(getattr(state, k)) for k in ("mean", "var", "count")}


def _port_policy(name, obs, ps):
    """A port policy holding one seed's JAX state (student and teacher)."""
    cls = StudentTeacher if name == "feedforward" else StudentTeacherRecurrent
    policy = cls({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS, device="cpu", **POLICIES[name])
    aux = {"teacher": ps.aux["teacher"], "teacher_norm": _norm(ps.aux["teacher_norm"]),
           "memory_t": ps.aux.get("memory_t")}
    from_jax_state(ps.params, {"student": _norm(ps.norm["student"])}, policy, aux)
    return policy


def _seed(tree, g):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[g], tree)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_stacked_update_matches_vmapped_jax(name):
    """One multi-seed distillation update (2 epochs of a 12-step window in
    segments of 5, a 4-step forward-only tail, the masked clip) against
    ``jax.vmap`` of JAX ``make_update_fn``: each seed's logged loss, every
    updated student parameter (the teachers untouched) and the acting carry
    after the replay."""
    env = JaxDRNLink(N, LINKS, max_episode_length=6)
    _, obs = env.reset(jax.random.PRNGKey(0))
    cls = JaxST if name == "feedforward" else JaxSTR
    jalg = JaxDistillation(cls(obs, GROUPS, env.num_actions, **POLICIES[name]), **ALG_KW)
    init, _ = jax_make_multiseed_train(jalg, env, T, G)
    ts0, cs0 = init(jax.random.PRNGKey(1))
    keys = jax.random.split(jax.random.PRNGKey(2), G)
    cs0 = cs0.replace(env_state=jax.vmap(env.randomize_episode_length)(cs0.env_state, keys))
    ts1, cs1, rollout, _ = jax.jit(jax.vmap(jalg.make_collect_fn(env, T)))(ts0, cs0)
    dones = np.asarray(rollout.dones)
    assert dones.any() and not (dones[0] == dones[1]).all()
    ts2, cs2, um = jax.jit(jax.vmap(jalg.make_update_fn()))(ts1, cs1, rollout)
    ts1, ts2, cs1, cs2, rollout, um = jax.device_get((ts1, ts2, cs1, cs2, rollout, um))

    seed_obs = _seed(cs1.obs, 0)
    policies = [_port_policy(name, seed_obs, _seed(ts1.policy, g)) for g in range(G)]
    alg = Distillation(policies[0], **ALG_KW)
    ts = alg.init_stacked_state(policies, N)
    assert set(ts.adam_mu) == {n for n, p in policies[0].named_parameters() if p.requires_grad}
    teacher0 = {k: v.clone() for k, v in ts.params.items() if not v.requires_grad}
    recurrent = policies[0].is_recurrent
    port_rollout = Rollout(
        obs={k: _t(v) for k, v in rollout.obs.items()}, actions=_t(rollout.actions), rewards=_t(rollout.rewards),
        dones=_t(rollout.dones), privileged_actions=_t(rollout.privileged_actions),
        carry0=tree_map(_t, rollout.carry0) if recurrent else ())
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()}, carry=tree_map(_t, cs1.carry),
                      stats=None)
    ts, cs, metrics = alg.update_stacked(ts, cs, port_rollout)

    _close(metrics["Loss/behavior"], um["Loss/behavior"], 3e-4, 3e-5, "Loss/behavior")
    for g in range(G):
        want = _port_policy(name, seed_obs, _seed(ts2.policy, g))
        for n, p in want.named_parameters():
            _close(ts.params[n][g], p, 3e-4, 3e-5, f"seed {g} updated {n}")
    for n, v in teacher0.items():
        assert torch.equal(ts.params[n], v), n
    if recurrent:
        for a, b in zip(jax.tree_util.tree_leaves(cs.carry), jax.tree_util.tree_leaves(cs2.carry)):
            _close(a, b, 3e-4, 3e-5, "carry after the update")


# ------------------------------------------------------------ the runner

TEACHER_CFG = {
    "num_steps_per_env": 6, "seed": 5, "save_interval": 10,
    "obs_groups": {"policy": ["privileged"], "critic": ["privileged"]},
    "policy": {"class_name": "ActorCriticRecurrent", "rnn_type": "gru", "rnn_hidden_dim": HID,
               "actor_hidden_dims": [16, 16], "critic_hidden_dims": [16, 16], "actor_obs_normalization": True},
    "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2},
}
STUDY_CFG = {
    "num_steps_per_env": T, "seed": 6, "save_interval": 10,
    "obs_groups": {"policy": ["policy"], "teacher": ["privileged"], "critic": ["policy"]},
    "policy": {"class_name": "StudentTeacherRecurrent", **POLICIES["gru_teacher_recurrent"]},
    "algorithm": {"class_name": "Distillation", **ALG_KW},
}


@pytest.fixture(scope="module")
def teacher_path(tmp_path_factory):
    """A recurrent RL teacher (GRU actor memory, actor normalizer) after one
    iteration, saved with ``OnPolicyRunner.save``."""
    runner = OnPolicyRunner(DomainRandomizedNLink(N, LINKS, device="cpu"), copy.deepcopy(TEACHER_CFG), device="cpu")
    runner.learn(1)
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.pt")
    runner.save(path)
    return path, runner.alg.policy


def _study(**keys):
    return MultiSeedRunner(DomainRandomizedNLink(N, LINKS, device="cpu"), {**copy.deepcopy(STUDY_CFG), **keys}, G,
                           device="cpu")


def test_load_teacher_gives_every_seed_one_teacher(teacher_path):
    """``load_teacher`` copies the actor, its normalizer and its memory
    (``memory_a`` -> ``memory_t``) into every seed; the students keep their
    distinct inits and their optimizer state."""
    path, teacher = teacher_path
    study = _study()
    students = {k: v.clone() for k, v in {**study.train_state.params, **study.train_state.buffers}.items()
                if k.startswith(("student.", "memory_s.", "norm_student.", "std"))}
    study.load_teacher(path)
    ts = study.train_state
    source = {**dict(teacher.named_parameters()), **dict(teacher.named_buffers())}
    remap = {"teacher.": "actor.", "norm_teacher.": "norm_actor.", "memory_t.": "memory_a."}
    checked = 0
    for name, v in {**ts.params, **ts.buffers}.items():
        prefix = next((p for p in remap if name.startswith(p)), None)
        if prefix is not None:
            for g in range(G):
                assert torch.equal(v[g], source[remap[prefix] + name[len(prefix):]]), name
            checked += 1
        elif name in students:
            assert torch.equal(v, students[name]), name
    assert checked and study.alg.policy.loaded_teacher
    assert not torch.equal(ts.params["student.dense_0.weight"][0], ts.params["student.dense_0.weight"][1])


def test_study_loss_drops_for_every_seed(teacher_path):
    """Behavior cloning of the loaded teacher: over 20 iterations each seed's
    loss falls (the mean of the last 3 below the mean of the first 3)."""
    study = _study()
    study.load_teacher(teacher_path[0])
    study.learn(20)
    losses = np.stack([h["metrics"]["Loss/behavior"] for h in study.history])
    assert losses.shape == (20, G) and np.isfinite(losses).all()
    assert (losses[-3:].mean(axis=0) < losses[:3].mean(axis=0)).all(), losses


def test_dispatched_study_equals_split_study(teacher_path):
    """A distillation study run at K=2 gives the split run's state and
    metrics bit for bit, the teacher loaded after construction."""
    runs = []
    for keys in ({}, {"iterations_per_dispatch": 2}):
        study = _study(**keys)
        study.load_teacher(teacher_path[0])
        study.learn(3)
        runs.append(study)
    for x, y in zip(runs[0].train_state.seed_tensors(), runs[1].train_state.seed_tensors()):
        assert torch.equal(x, y)
    for a, b in zip(runs[0].history, runs[1].history):
        assert all(np.array_equal(a["metrics"][k], b["metrics"][k]) for k in a["metrics"])


def test_refusals(teacher_path, tmp_path):
    """``learn`` without a teacher, ``load_teacher`` of a distillation
    checkpoint (it has student parameters) and ``load_teacher`` into a study
    whose policy has no teacher each raise ``ValueError``."""
    study = _study()
    with pytest.raises(ValueError, match="Teacher model parameters not loaded"):
        study.learn(1)
    student = DistillationRunner(DomainRandomizedNLink(N, LINKS, device="cpu"),
                                 {k: v for k, v in copy.deepcopy(STUDY_CFG).items()}, device="cpu")
    student.load(teacher_path[0])
    path = str(tmp_path / "student.pt")
    student.save(path)
    with pytest.raises(ValueError, match="distillation checkpoint"):
        study.load_teacher(path)
    ppo_study = MultiSeedRunner(DomainRandomizedNLink(N, LINKS, device="cpu"), copy.deepcopy(TEACHER_CFG), G,
                                device="cpu")
    with pytest.raises(ValueError, match="no teacher"):
        ppo_study.load_teacher(teacher_path[0])
