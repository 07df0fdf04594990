"""The port's checkpoints (``utils/checkpoint.py``, ``OnPolicyRunner.save`` /
``load`` / ``load_latest``) and inference policy: a resume restores the
training state bit for bit and training then continues identically; an RL
checkpoint bootstraps a distillation teacher (its recurrent memory
included) bit for bit and drops the teacher's optimizer state; malformed
inputs and incompatible checkpoints raise, the latter naming both causes.
No JAX: the format is the port's own (the JAX package's is an orbax
directory, ``tests/test_checkpoint.py``)."""

import copy
import os

import pytest
import torch

from rsl_rl_tpu_torch.env import DomainRandomizedNLink, NLinkPendulum
from rsl_rl_tpu_torch.runners import DistillationRunner, OnPolicyRunner
from rsl_rl_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint

N, LINKS, T = 8, 3, 6


def _ppo_cfg(recurrent=False, hidden=(16, 16)):
    policy = {"class_name": "ActorCriticRecurrent" if recurrent else "ActorCritic",
              "actor_hidden_dims": list(hidden), "critic_hidden_dims": list(hidden),
              "actor_obs_normalization": True, "critic_obs_normalization": True}
    if recurrent:
        policy.update(rnn_type="gru", rnn_hidden_dim=8)
    return {"num_steps_per_env": T, "seed": 1, "obs_groups": {"policy": ["privileged"], "critic": ["privileged"]},
            "policy": policy, "algorithm": {"class_name": "PPO", "num_learning_epochs": 2, "num_mini_batches": 2}}


def _distill_cfg(teacher_recurrent=False, teacher_hidden=(16, 16), teacher_norm=True):
    return {"num_steps_per_env": T, "seed": 2, "obs_groups": {"policy": ["policy"], "teacher": ["privileged"]},
            "policy": {"class_name": "StudentTeacherRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 8,
                       "student_hidden_dims": [16], "teacher_hidden_dims": list(teacher_hidden),
                       "student_obs_normalization": True, "teacher_obs_normalization": teacher_norm,
                       "teacher_recurrent": teacher_recurrent},
            "algorithm": {"class_name": "Distillation", "gradient_length": 4, "max_grad_norm": 1.0}}


def _env():
    return DomainRandomizedNLink(N, LINKS, max_episode_length=5, device="cpu")


def _state(runner):
    """Everything a resume restores: policy state, Adam moments and count, lr."""
    alg = runner.alg
    return {**{f"model.{k}": v for k, v in alg.policy.state_dict().items()},
            **{f"mu.{k}": v for k, v in zip(alg.param_names, alg.adam_mu)},
            **{f"nu.{k}": v for k, v in zip(alg.param_names, alg.adam_nu)},
            "count": alg.adam_count, "lr": alg.lr}


def _assert_equal_states(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _continue_from(runner, other):
    """Give ``runner`` ``other``'s collection state and action-noise
    generator (the part of a run a checkpoint does not hold)."""
    runner.collect_state = copy.deepcopy(other.collect_state)
    runner.alg.generator.set_state(other.alg.generator.get_state())


@pytest.fixture(scope="module")
def teacher_ckpt(tmp_path_factory):
    """A feedforward PPO teacher trained 2 iterations on the privileged obs."""
    runner = OnPolicyRunner(_env(), _ppo_cfg(), device="cpu")
    runner.learn(2)
    path = str(tmp_path_factory.mktemp("teacher") / "model_1.pt")
    runner.save(path, infos={"note": "teacher"})
    return path, runner


@pytest.mark.parametrize("recurrent", [False, True], ids=["feedforward", "recurrent"])
def test_ppo_resume_is_bitwise_and_continues_identically(tmp_path, recurrent):
    a = OnPolicyRunner(_env(), _ppo_cfg(recurrent), device="cpu")
    a.learn(2)
    path = str(tmp_path / "model_1.pt")
    a.save(path, infos={"env_steps": 96})
    b = OnPolicyRunner(_env(), _ppo_cfg(recurrent), device="cpu")
    assert b.load(path) == {"env_steps": 96}
    assert b.current_learning_iteration == a.current_learning_iteration == 1
    _assert_equal_states(_state(a), _state(b))
    _continue_from(b, a)
    a.learn(1)
    b.learn(1)
    _assert_equal_states(_state(a), _state(b))
    assert a.history[-1]["metrics"] == b.history[-1]["metrics"]


def test_load_without_optimizer_keeps_the_fresh_one(tmp_path):
    a = OnPolicyRunner(_env(), _ppo_cfg(), device="cpu")
    a.learn(1)
    a.save(str(tmp_path / "model_0.pt"))
    b = OnPolicyRunner(_env(), _ppo_cfg(), device="cpu")
    b.load(str(tmp_path / "model_0.pt"), load_optimizer=False)
    assert int(b.alg.adam_count) == 0 and all(not m.any() for m in b.alg.adam_mu)
    for k, v in a.alg.policy.state_dict().items():
        assert torch.equal(b.alg.policy.state_dict()[k], v), k


@pytest.mark.parametrize("teacher_recurrent", [False, True], ids=["mlp_teacher", "recurrent_teacher"])
def test_teacher_bootstrap_from_a_ppo_checkpoint(tmp_path, teacher_recurrent):
    """An RL checkpoint loaded into a distillation runner gives the teacher
    the actor, its normalizer and (recurrent teacher) ``memory_a``, bit for
    bit; it is not a resume, so the iteration and the fresh optimizer stay.
    The teacher's actions then equal the trained actor's deterministic ones."""
    teacher = OnPolicyRunner(_env(), _ppo_cfg(recurrent=teacher_recurrent), device="cpu")
    teacher.learn(1)
    path = str(tmp_path / "teacher.pt")
    teacher.save(path)
    student = DistillationRunner(_env(), _distill_cfg(teacher_recurrent), device="cpu")
    student.load(path)
    policy, actor = student.alg.policy, teacher.alg.policy
    assert policy.loaded_teacher and student.current_learning_iteration == 0
    assert int(student.alg.adam_count) == 0
    pairs = [(policy.teacher, actor.actor), (policy.norm_teacher, actor.norm_actor)]
    if teacher_recurrent:
        pairs.append((policy.memory_t, actor.memory_a))
    for mine, theirs in pairs:
        for (k, v), (_, w) in zip(mine.state_dict().items(), theirs.state_dict().items()):
            assert v.dtype == torch.float32 and torch.equal(v, w), k
    obs = student.collect_state.obs
    carry = policy.initial_carry(N)
    want, _ = actor.act_inference(obs, actor.initial_carry(N))
    got, _ = policy.evaluate(obs, carry)
    assert torch.equal(got, want.detach())
    student.learn(1)
    assert all(torch.isfinite(torch.tensor(v)) for v in student.history[0]["metrics"].values())


def test_distillation_resume_is_bitwise_and_continues_identically(tmp_path, teacher_ckpt):
    path, _ = teacher_ckpt
    a = DistillationRunner(_env(), _distill_cfg(), device="cpu")
    a.load(path)
    a.learn(2)
    snap = str(tmp_path / "model_1.pt")
    a.save(snap)
    b = DistillationRunner(_env(), _distill_cfg(), device="cpu")
    b.load(snap)
    assert b.current_learning_iteration == 1 and b.alg.policy.loaded_teacher
    _assert_equal_states(_state(a), _state(b))
    _continue_from(b, a)
    a.learn(1)
    b.learn(1)
    _assert_equal_states(_state(a), _state(b))


@pytest.mark.parametrize("mismatch", ["teacher_width", "teacher_norm"])
def test_incompatible_checkpoint_names_both_causes(teacher_ckpt, mismatch):
    """A PPO checkpoint whose actor does not fit the configured teacher
    neither restores into the distillation policy nor remaps: the error
    names both causes, and nothing was loaded."""
    path, _ = teacher_ckpt
    cfg = _distill_cfg(teacher_hidden=(12, 12)) if mismatch == "teacher_width" else _distill_cfg(teacher_norm=False)
    runner = DistillationRunner(_env(), cfg, device="cpu")
    before = copy.deepcopy(runner.alg.policy.state_dict())
    with pytest.raises(ValueError, match="neither restores into the configured policy") as err:
        runner.load(path)
    assert "incompatible with the current model configuration" in str(err.value)
    assert ("teacher network" if mismatch == "teacher_width" else "normalization mismatch") in str(err.value)
    assert not runner.alg.policy.loaded_teacher
    for k, v in runner.alg.policy.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_ppo_checkpoint_of_another_width_raises(teacher_ckpt):
    runner = OnPolicyRunner(_env(), _ppo_cfg(hidden=(12, 12)), device="cpu")
    with pytest.raises(ValueError, match="shape mismatches"):
        runner.load(teacher_ckpt[0])


def test_load_latest(tmp_path):
    runner = OnPolicyRunner(_env(), _ppo_cfg(), device="cpu")
    assert not runner.load_latest(str(tmp_path))
    assert not runner.load_latest(str(tmp_path / "missing"))
    for it in (1, 5, 30):
        runner.current_learning_iteration = it
        runner.save(str(tmp_path / f"model_{it}.pt"), infos={"it": it})
    (tmp_path / "model_99.ckpt").write_text("not ours")
    assert latest_checkpoint(str(tmp_path)).endswith("model_30.pt")
    fresh = OnPolicyRunner(_env(), _ppo_cfg(), device="cpu")
    assert fresh.load_latest(str(tmp_path))
    assert fresh.current_learning_iteration == 30


class TestMalformedInputs:
    def test_missing_path_raises_filenotfound(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path / "nope.pt"))

    def test_garbage_file_fails_safely(self, tmp_path):
        p = tmp_path / "model_3.pt"
        p.write_bytes(b"\x80\x04not a checkpoint")  # e.g. a stale pickle
        with pytest.raises(ValueError, match="Failed to read checkpoint"):
            load_checkpoint(str(p))

    def test_plain_torch_file_rejected(self, tmp_path):
        p = tmp_path / "model_4.pt"
        torch.save({"model": {}}, p)
        with pytest.raises(ValueError, match="not an rsl_rl_tpu_torch checkpoint"):
            load_checkpoint(str(p))

    def test_directory_rejected(self, tmp_path):
        d = tmp_path / "model_5.ckpt"
        d.mkdir()
        (d / "junk").write_text("junk")
        with pytest.raises(ValueError, match="not an rsl_rl_tpu_torch checkpoint"):
            load_checkpoint(str(d))

    def test_pickled_code_is_refused(self, tmp_path):
        """``weights_only`` loading: an object that would run code on load
        is refused, never executed."""
        p = tmp_path / "model_6.pt"
        torch.save({"format": "rsl_rl_tpu_torch", "infos": os.system}, p)
        with pytest.raises(ValueError, match="Failed to read checkpoint"):
            load_checkpoint(str(p))

    def test_round_trip_of_plain_state(self, tmp_path):
        p = str(tmp_path / "model_7.pt")
        save_checkpoint(p, {"a": torch.ones(2), "iter": 7, "infos": None, "nested": {"b": [torch.zeros(1), 2.5]}})
        state = load_checkpoint(p)
        assert state["iter"] == 7 and state["infos"] is None and state["nested"]["b"][1] == 2.5
        assert torch.equal(state["a"], torch.ones(2))
        save_checkpoint(p, {"a": 2 * torch.ones(2)})
        assert torch.equal(load_checkpoint(p)["a"], 2 * torch.ones(2))
        assert os.listdir(tmp_path) == ["model_7.pt"]


def test_inference_policy_keeps_and_resets_the_hidden_state():
    """A recurrent policy's inference callable carries its hidden state from
    call to call (so two calls on the same obs differ), and ``.reset``
    zeroes it: all of it, or where ``dones`` is set."""
    runner = OnPolicyRunner(NLinkPendulum(N, LINKS, device="cpu"),
                            {**_ppo_cfg(recurrent=True), "obs_groups": {"policy": ["policy"]}}, device="cpu")
    policy = runner.alg.policy
    obs = runner.collect_state.obs
    infer = runner.get_inference_policy()
    first = infer(obs)
    second = infer(obs)
    assert not torch.equal(first, second)
    infer.reset()
    assert torch.equal(infer(obs), first)
    carry = policy.initial_carry(N)
    _, carry = policy.act_inference(obs, carry)
    dones = torch.arange(N) % 2 == 0
    infer.reset(dones)
    want, _ = policy.act_inference(obs, policy.reset_carry(carry, dones))
    assert torch.equal(infer(obs), want.detach())
    ff = OnPolicyRunner(NLinkPendulum(N, LINKS, device="cpu"),
                        {**_ppo_cfg(), "obs_groups": {"policy": ["policy"]}}, device="cpu")
    act = ff.get_inference_policy(device="cpu")
    assert torch.equal(act(obs), ff.alg.policy.act_inference(obs)[0].detach())
