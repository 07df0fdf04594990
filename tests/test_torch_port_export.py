"""The port's export (``utils/export.py``) and deployment bridge
(``utils/torch_deploy.py``) on the CPU.

- ``export_policy`` / ``load_policy`` round trips through ``torch.export``,
  feedforward and recurrent (GRU, and a two-layer bf16 LSTM), against
  ``act_inference`` step by step, carry and per-env resets included.
- ``as_torch_policy`` against the JAX package's ``as_torch_policy`` on weights
  carried across with ``from_jax_state``: the same state-dict keys and values,
  and a stateful rollout with resets at rtol 1e-6 / atol 1e-6 against the
  JAX module and the port's ``act_inference``; activations (``gelu`` is
  jax.nn.gelu's tanh approximation in both packages), the state-dependent
  std's mean head, GRU and LSTM, one and two layers, and the students.
- ``export_torch_state_dict`` equals the JAX one key for key, and
  ``import_torch_state_dict`` / ``import_torch_checkpoint`` of it restore the
  port's policy exactly; the JAX module's refusals.
- ``export_onnx`` without ``onnx`` raises an actionable error.
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.modules import ActorCritic as JaxAC
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu.modules import StudentTeacher as JaxST
from rsl_rl_tpu.modules import StudentTeacherRecurrent as JaxSTR
from rsl_rl_tpu.utils.torch_deploy import as_torch_policy as jax_as_torch_policy
from rsl_rl_tpu.utils.torch_deploy import export_torch_state_dict as jax_export_torch_state_dict
from rsl_rl_tpu_torch.modules import ActorCritic, ActorCriticRecurrent, StudentTeacher, StudentTeacherRecurrent
from rsl_rl_tpu_torch.utils.export import export_policy, load_policy
from rsl_rl_tpu_torch.utils.torch_deploy import (
    as_torch_policy,
    export_onnx,
    export_torch_state_dict,
    import_torch_checkpoint,
    import_torch_state_dict,
)
from rsl_rl_tpu_torch.utils.weights import from_jax_state

B, D_POL, D_EXTRA, A = 5, 6, 3, 2
GROUPS = {"policy": ["policy", "extra"], "critic": ["policy", "extra"]}
ST_GROUPS = {**GROUPS, "teacher": ["policy", "extra"]}
TOL = dict(rtol=1e-6, atol=1e-6)


def _obs(seed, batch=B):
    rng = np.random.default_rng(seed)
    return {"policy": (rng.normal(size=(batch, D_POL)) * 2.0 + 0.5).astype(np.float32),
            "extra": rng.normal(size=(batch, D_EXTRA)).astype(np.float32)}


def _tobs(obs):
    return {k: torch.tensor(v) for k, v in obs.items()}


def _flat(obs):
    return torch.tensor(np.concatenate([obs["policy"], obs["extra"]], -1))


def _norm_np(state):
    return None if state is None else {k: np.asarray(getattr(state, k)) for k in ("mean", "var", "count")}


def _pair(jax_cls, cls, groups=GROUPS, **kw):
    """A JAX policy with a warmed normalizer, and the port's with its weights."""
    obs = _obs(0)
    jpolicy = jax_cls({k: jnp.asarray(v) for k, v in obs.items()}, groups, A, **kw)
    ps = jpolicy.init(jax.random.PRNGKey(1))
    ps = jpolicy.update_normalization(ps, {k: jnp.asarray(v) for k, v in _obs(2, 64).items()})
    policy = cls(_tobs(obs), groups, A, device="cpu", **kw)
    ps_np = jax.device_get(ps)
    if hasattr(policy, "student"):
        aux = {"teacher": ps_np.aux["teacher"], "teacher_norm": _norm_np(ps_np.aux.get("teacher_norm")),
               "memory_t": ps_np.aux.get("memory_t")}
        from_jax_state(ps_np.params, {"student": _norm_np(ps_np.norm["student"])}, policy, aux)
    else:
        from_jax_state(ps_np.params, {k: _norm_np(v) for k, v in ps_np.norm.items()}, policy)
    return jpolicy, ps, policy


def _same_state_dicts(module, jmodule):
    sd, jsd = module.state_dict(), jmodule.state_dict()
    assert list(sd) == list(jsd)
    for k in sd:
        assert sd[k].dtype == torch.float32 and sd[k].shape == jsd[k].shape, k
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k].numpy(), err_msg=k)


# ------------------------------------------------------------ torch.export


@pytest.mark.parametrize("kind", ["feedforward", "gru", "lstm2_bf16"])
def test_export_roundtrip(kind, tmp_path):
    obs = _tobs(_obs(0, 4))
    if kind == "feedforward":
        policy = ActorCritic(obs, GROUPS, A, actor_hidden_dims=[16], critic_hidden_dims=[16],
                             actor_obs_normalization=True, device="cpu")
    else:
        kw = dict(rnn_type="gru", rnn_hidden_dim=8) if kind == "gru" else \
            dict(rnn_type="lstm", rnn_hidden_dim=8, rnn_num_layers=2, dtype=torch.bfloat16)
        policy = ActorCriticRecurrent(obs, GROUPS, A, actor_hidden_dims=[8], critic_hidden_dims=[8],
                                      actor_obs_normalization=True, device="cpu", **kw)
    policy.update_normalization(_tobs(_obs(5, 64)))
    path = str(tmp_path / "policy.pt2")
    export_policy(policy, obs, path)
    loaded = load_policy(path)
    assert loaded.is_recurrent == policy.is_recurrent
    carry = policy.initial_carry(4)
    dones = torch.tensor([False, True, False, False])
    with torch.no_grad():
        for t in range(4):
            step_obs = _tobs(_obs(10 + t, 4))
            want, carry = policy.act_inference(step_obs, carry)
            np.testing.assert_allclose(loaded(step_obs).numpy(), want.numpy(), **TOL, err_msg=f"step {t}")
            if t == 1:  # a per-env reset, as get_inference_policy's reset(dones)
                carry = policy.reset_carry(carry, dones)
                loaded.reset(dones)
        loaded.reset()
        want, _ = policy.act_inference(obs, policy.initial_carry(4))
        np.testing.assert_allclose(loaded(obs).numpy(), want.numpy(), **TOL)


# ------------------------------------------------------- as_torch_policy


@pytest.mark.parametrize("activation", ["elu", "tanh", "gelu", "crelu", "mish"])
def test_actor_matches_jax(activation):
    jpolicy, ps, policy = _pair(JaxAC, ActorCritic, actor_hidden_dims=[16, 8], critic_hidden_dims=[16],
                                activation=activation, actor_obs_normalization=True)
    obs = _obs(3)
    want, _ = jpolicy.act_inference(ps, {k: jnp.asarray(v) for k, v in obs.items()}, ())
    module, jmodule = as_torch_policy(policy).eval(), jax_as_torch_policy(jpolicy, ps).eval()
    _same_state_dicts(module, jmodule)
    assert module.obs_names == ["policy", "extra"] and not module.is_recurrent
    with torch.no_grad():
        got = module(_flat(obs))
        port, _ = policy.act_inference(_tobs(obs))
        np.testing.assert_allclose(got.numpy(), jmodule(_flat(obs)).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), port.numpy(), **TOL)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=1e-5)


def test_state_dependent_std_exports_the_mean_head():
    jpolicy, ps, policy = _pair(JaxAC, ActorCritic, actor_hidden_dims=[16], critic_hidden_dims=[16],
                                state_dependent_std=True)
    module, jmodule = as_torch_policy(policy).eval(), jax_as_torch_policy(jpolicy, ps).eval()
    _same_state_dicts(module, jmodule)
    obs = _obs(2)
    with torch.no_grad():
        got = module(_flat(obs))
        port, _ = policy.act_inference(_tobs(obs))
    assert got.shape == (B, A)
    np.testing.assert_allclose(got.numpy(), port.numpy(), **TOL)


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_recurrent_rollout_with_resets_matches(rnn_type, num_layers):
    jpolicy, ps, policy = _pair(JaxACR, ActorCriticRecurrent, rnn_type=rnn_type, rnn_hidden_dim=12,
                                rnn_num_layers=num_layers, actor_hidden_dims=[16], critic_hidden_dims=[16],
                                actor_obs_normalization=True)
    module, jmodule = as_torch_policy(policy).eval(), jax_as_torch_policy(jpolicy, ps).eval()
    _same_state_dicts(module, jmodule)
    assert module.is_recurrent and module.is_lstm == (rnn_type == "lstm")
    carry, hidden, jhidden = policy.initial_carry(B), None, None
    dones = torch.tensor([False, True, False, True, False])
    with torch.no_grad():
        for t in range(5):
            obs = _obs(10 + t)
            want, carry = policy.act_inference(_tobs(obs), carry)
            got, hidden = module(_flat(obs), hidden)
            jgot, jhidden = jmodule(_flat(obs), jhidden)
            np.testing.assert_allclose(got.numpy(), jgot.numpy(), **TOL, err_msg=f"step {t}")
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL, err_msg=f"step {t}")
            if t == 2:  # zeroing a batch column of the hidden state is the reset
                carry = policy.reset_carry(carry, dones)
                for h in (hidden if rnn_type == "lstm" else (hidden,)) + (jhidden if rnn_type == "lstm" else (jhidden,)):
                    h[:, dones] = 0.0
    h_torch = hidden[0] if rnn_type == "lstm" else hidden
    for layer in range(num_layers):
        want_h = carry["actor"][layer][1] if rnn_type == "lstm" else carry["actor"][layer]
        np.testing.assert_allclose(h_torch[layer].numpy(), want_h.numpy(), **TOL)


def test_students_match_jax():
    for jcls, cls, kw in ((JaxST, StudentTeacher, {}),
                          (JaxSTR, StudentTeacherRecurrent, dict(rnn_type="gru", rnn_hidden_dim=8))):
        jpolicy, ps, policy = _pair(jcls, cls, ST_GROUPS, student_hidden_dims=[16], teacher_hidden_dims=[16],
                                    student_obs_normalization=True, **kw)
        module, jmodule = as_torch_policy(policy).eval(), jax_as_torch_policy(jpolicy, ps).eval()
        _same_state_dicts(module, jmodule)
        carry, hidden = policy.initial_carry(B), None
        with torch.no_grad():
            for t in range(3):
                obs = _obs(20 + t)
                want, carry = policy.act_inference(_tobs(obs), carry)
                got = module(_flat(obs))
                if policy.is_recurrent:
                    got, hidden = module(_flat(obs), hidden)
                np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ------------------------------------------------- reference state dicts


@pytest.mark.parametrize("kind", ["feedforward_log_std", "gru", "lstm", "student_gru"])
def test_state_dict_export_matches_jax_and_imports_back(kind, tmp_path):
    if kind == "feedforward_log_std":
        args = (JaxAC, ActorCritic, GROUPS)
        kw = dict(actor_hidden_dims=[16, 8], critic_hidden_dims=[8], noise_std_type="log",
                  actor_obs_normalization=True, critic_obs_normalization=True)
    elif kind == "student_gru":
        args = (JaxSTR, StudentTeacherRecurrent, ST_GROUPS)
        kw = dict(student_hidden_dims=[16], teacher_hidden_dims=[16], rnn_type="gru", rnn_hidden_dim=8,
                  student_obs_normalization=True)
    else:
        args = (JaxACR, ActorCriticRecurrent, GROUPS)
        kw = dict(actor_hidden_dims=[16], critic_hidden_dims=[16], rnn_type=kind, rnn_hidden_dim=8,
                  rnn_num_layers=2, critic_obs_normalization=True)
    jpolicy, ps, policy = _pair(*args, **kw)
    sd, jsd = export_torch_state_dict(policy), jax_export_torch_state_dict(jpolicy, ps)
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        assert sd[k].dtype == jsd[k].dtype and sd[k].shape == jsd[k].shape, k
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k].numpy(), err_msg=k)

    fresh = args[1](_tobs(_obs(0)), args[2], A, device="cpu", seed=9, **kw)
    assert not all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), policy.state_dict().values()))
    path = str(tmp_path / "model.pt")
    torch.save({"model_state_dict": sd, "iter": 7}, path)
    assert import_torch_checkpoint(fresh, path) == 7
    for (k, a), b in zip(fresh.state_dict().items(), policy.state_dict().values()):
        assert torch.equal(a, b), k
    if hasattr(fresh, "loaded_teacher"):
        assert fresh.loaded_teacher


def test_import_folds_the_paired_biases():
    """A reference GRU/LSTM with nonzero biases on both sides imports as the
    same function: the module built back from the import equals it."""
    for rnn_type in ("gru", "lstm"):
        policy = ActorCriticRecurrent(_tobs(_obs(0)), GROUPS, A, actor_hidden_dims=[8], critic_hidden_dims=[8],
                                      rnn_type=rnn_type, rnn_hidden_dim=6, device="cpu")
        sd = export_torch_state_dict(policy)
        gen = torch.Generator().manual_seed(0)
        for k in sd:
            if ".bias_" in k:
                sd[k] = torch.randn(sd[k].shape, generator=gen)
        ref = torch.nn.GRU(D_POL + D_EXTRA, 6) if rnn_type == "gru" else torch.nn.LSTM(D_POL + D_EXTRA, 6)
        ref.load_state_dict({k.removeprefix("memory_a.rnn."): v for k, v in sd.items() if k.startswith("memory_a.rnn.")})
        import_torch_state_dict(policy, sd)
        x = _flat(_obs(4)).unsqueeze(0)
        with torch.no_grad():
            np.testing.assert_allclose(as_torch_policy(policy).memory(x)[0].numpy(), ref(x)[0].numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_import_refusals():
    _, _, policy = _pair(JaxAC, ActorCritic, actor_hidden_dims=[8], critic_hidden_dims=[8],
                         actor_obs_normalization=True)
    sd = export_torch_state_dict(policy)
    plain = ActorCritic(_tobs(_obs(0)), GROUPS, A, actor_hidden_dims=[8], critic_hidden_dims=[8], device="cpu")
    with pytest.raises(ValueError, match="actor_obs_normalization=False"):
        import_torch_state_dict(plain, sd)
    log_std = ActorCritic(_tobs(_obs(0)), GROUPS, A, actor_hidden_dims=[8], critic_hidden_dims=[8],
                          actor_obs_normalization=True, noise_std_type="log", device="cpu")
    with pytest.raises(KeyError, match="log_std"):
        import_torch_state_dict(log_std, sd)
    wider = ActorCritic(_tobs(_obs(0)), GROUPS, A, actor_hidden_dims=[9], critic_hidden_dims=[8],
                        actor_obs_normalization=True, device="cpu")
    before = {k: v.clone() for k, v in wider.state_dict().items()}
    with pytest.raises(ValueError, match="expected"):
        import_torch_state_dict(wider, sd)
    assert all(torch.equal(before[k], v) for k, v in wider.state_dict().items())  # nothing copied


def test_missing_onnx_raises_an_actionable_error(tmp_path):
    if importlib.util.find_spec("onnx") is not None:
        pytest.skip("onnx installed; the error is for machines without it")
    policy = ActorCritic(_tobs(_obs(0)), GROUPS, A, actor_hidden_dims=[8], critic_hidden_dims=[8], device="cpu")
    with pytest.raises(RuntimeError, match="onnx"):
        export_onnx(policy, str(tmp_path / "p.onnx"))
