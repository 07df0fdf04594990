"""bf16 trunks and the LSTM policy of the port against the JAX package.

- ``MLP(dtype=bf16, head_dtype=fp32)`` against flax's ``MLP`` with the same
  dtypes (bf16 trunk layers, fp32 head, fp32 output);
- ``ActorCriticRecurrent(rnn_type="lstm")`` after ``from_jax_state``: one
  acting step and the update's ``act_value_seq`` over a window with resets,
  values and gradients, in fp32 and with ``dtype=bfloat16`` (bf16 trunks, bf16
  memory operands, fp32 heads and state).

JAX runs on the CPU (its recurrent replay takes the scan path of
``Memory.step`` there); the port runs its plain versions on the CPU. fp32
holds the bars of ``tests/test_torch_port_ppo.py``; bf16 holds the bf16 bars
of ``tests/test_pallas_rnn.py`` (values rtol 5e-2 / atol 3e-2, gradients a
relative L2 error under 5e-2): bf16 rounds at other places in XLA and in
PyTorch (XLA's CPU elementwise ops in bf16, torch's in fp32 then rounded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu.networks.mlp import MLP as JaxMLP
from rsl_rl_tpu_torch.modules import ActorCriticRecurrent
from rsl_rl_tpu_torch.networks.mlp import MLP
from rsl_rl_tpu_torch.utils.weights import from_jax_state

N, OBS, ACT, HID, T = 16, 9, 3, 32, 6
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
POLICY_KW = dict(rnn_type="lstm", rnn_hidden_dim=HID, actor_hidden_dims=[32, 32],
                 critic_hidden_dims=[32, 32], actor_obs_normalization=True,
                 critic_obs_normalization=True)
DTYPES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
#: (value rtol, value atol, gradient relative L2) per mode
BARS = {"fp32": (1e-5, 1e-5, 2e-4), "bf16": (5e-2, 3e-2, 5e-2)}


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got.detach().numpy().astype(np.float64) - want) / (np.linalg.norm(want) + 1e-6)


def _norm_np(norm):
    return {k: None if v is None else {"mean": np.asarray(v.mean), "var": np.asarray(v.var),
                                       "count": np.asarray(v.count)}
            for k, v in norm.items()}


def test_mlp_bf16_trunk_fp32_head_matches_flax():
    """Values of the bf16 trunk + fp32 head, and the gradients of every
    parameter (fp32 parameters on both sides)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 12)).astype(np.float32)
    jmlp = JaxMLP(output_dim=4, hidden_dims=[64, 64], dtype=jnp.bfloat16, head_dtype=jnp.float32)
    params = jmlp.init(jax.random.PRNGKey(1), jnp.zeros((1, 12)))["params"]
    want = jmlp.apply({"params": params}, jnp.asarray(x))
    assert want.dtype == jnp.float32
    gparams = jax.grad(lambda p: jnp.sum(jnp.sin(jmlp.apply({"params": p}, jnp.asarray(x)))))(params)

    mlp = MLP(12, 4, [64, 64], dtype=torch.bfloat16, head_dtype=torch.float32)
    with torch.no_grad():
        for i in range(mlp.num_linear):
            layer = getattr(mlp, f"dense_{i}")
            layer.weight.copy_(torch.tensor(np.asarray(params[f"dense_{i}"]["kernel"]).T))
            layer.bias.copy_(torch.tensor(np.asarray(params[f"dense_{i}"]["bias"])))
    got = mlp(torch.tensor(x))
    assert got.dtype == torch.float32 and mlp.dense_0.weight.dtype == torch.float32
    rtol, atol, l2 = BARS["bf16"]
    _close(got, want, rtol, atol, "output")
    torch.sum(torch.sin(got)).backward()
    for i in range(mlp.num_linear):
        layer = getattr(mlp, f"dense_{i}")
        for name, g, w in (("kernel", layer.weight.grad.T, gparams[f"dense_{i}"]["kernel"]),
                           ("bias", layer.bias.grad, gparams[f"dense_{i}"]["bias"])):
            assert _rel_l2(g, w) < l2, f"dense_{i}.{name}: relative L2 {_rel_l2(g, w):.3e}"


def test_mlp_and_policy_refuse_other_dtypes():
    with pytest.raises(ValueError, match="dtype"):
        MLP(4, 2, [8], dtype=torch.float16)
    obs = {"policy": torch.zeros(2, OBS)}
    with pytest.raises(ValueError, match="dtype"):
        ActorCriticRecurrent(obs, GROUPS, ACT, device="cpu", dtype=torch.float16, **POLICY_KW)


def _setup(mode):
    jdtype, tdtype = DTYPES[mode]
    rng = np.random.default_rng(2)
    obs = {"policy": jnp.asarray(rng.normal(size=(N, OBS)).astype(np.float32))}
    jpolicy = JaxACR(obs, GROUPS, ACT, dtype=jdtype, **POLICY_KW)
    ps = jpolicy.init(jax.random.PRNGKey(3))
    ps = jpolicy.update_normalization(ps, obs)
    policy = ActorCriticRecurrent({"policy": torch.tensor(np.asarray(obs["policy"]))}, GROUPS, ACT,
                                  device="cpu", dtype=tdtype, **POLICY_KW)
    from_jax_state(jax.device_get(ps.params), _norm_np(ps.norm), policy)
    return rng, jpolicy, ps, policy


def _carry(rng):
    """A random ``(c, h)`` carry of one layer per memory, numpy and torch."""
    carry = {k: ((rng.normal(size=(N, HID)).astype(np.float32),
                  (0.5 * rng.normal(size=(N, HID))).astype(np.float32)),) for k in ("actor", "critic")}
    jcarry = {k: tuple(tuple(jnp.asarray(a) for a in layer) for layer in v) for k, v in carry.items()}
    tcarry = {k: tuple(tuple(torch.tensor(a) for a in layer) for layer in v) for k, v in carry.items()}
    return jcarry, tcarry


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_lstm_policy_acting_matches_jax(mode):
    """One acting step: ``act``, ``value``, ``act_inference`` and the new carries."""
    rng, jpolicy, ps, policy = _setup(mode)
    rtol, atol, _ = BARS[mode]
    obs = {"policy": rng.normal(size=(N, OBS)).astype(np.float32)}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    tobs = {k: torch.tensor(v) for k, v in obs.items()}
    jcarry, tcarry = _carry(rng)
    want_mean, want_std, want_carry = jpolicy.act(ps, jobs, jcarry)
    want_value, want_vcarry = jpolicy.value(ps, jobs, jcarry)
    want_inf, _ = jpolicy.act_inference(ps, jobs, jcarry)
    with torch.no_grad():
        mean, std, new_carry = policy.act(tobs, tcarry)
        value, new_vcarry = policy.value(tobs, tcarry)
        inf, _ = policy.act_inference(tobs, tcarry)
    for name, got, want in (("mean", mean, want_mean), ("std", std, want_std), ("value", value, want_value),
                            ("act_inference", inf, want_inf)):
        _close(got, want, rtol, atol, name)
    for k in range(2):
        _close(new_carry["actor"][0][k], want_carry["actor"][0][k], rtol, atol, f"actor carry {k}")
        _close(new_vcarry["critic"][0][k], want_vcarry["critic"][0][k], rtol, atol, f"critic carry {k}")


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_lstm_policy_act_value_seq_matches_jax(mode):
    """The update's replay of a ``[T, N]`` window with resets from a
    window-start carry: mean, std, value, and the gradients of every
    parameter of a loss on them."""
    rng, jpolicy, ps, policy = _setup(mode)
    rtol, atol, l2 = BARS[mode]
    obs = {"policy": rng.normal(size=(T, N, OBS)).astype(np.float32)}
    resets = rng.random((T, N)) < 0.2
    resets[0] = False
    jcarry, tcarry = _carry(rng)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}

    def jax_loss(params):
        mean, std, value = jpolicy.act_value_seq(ps.replace(params=params), jobs, jcarry, jnp.asarray(resets))
        return jnp.sum(jnp.sin(mean) * std) + jnp.sum(jnp.cos(value)), (mean, std, value)

    gparams, (want_mean, want_std, want_value) = jax.grad(jax_loss, has_aux=True)(ps.params)
    mean, std, value = policy.act_value_seq({k: torch.tensor(v) for k, v in obs.items()}, tcarry,
                                            torch.tensor(resets))
    for name, got, want in (("mean", mean, want_mean), ("std", std, want_std), ("value", value, want_value)):
        _close(got, want, rtol, atol, name)
    (torch.sum(torch.sin(mean) * std) + torch.sum(torch.cos(value))).backward()

    # the JAX gradients in the port's layout: load them as the weights of a twin
    want_grads = ActorCriticRecurrent({"policy": torch.zeros(N, OBS)}, GROUPS, ACT, device="cpu",
                                      dtype=DTYPES[mode][1], **POLICY_KW)
    from_jax_state(jax.device_get(gparams), _norm_np(ps.norm), want_grads)
    for (name, p), (_, w) in zip(policy.named_parameters(), want_grads.named_parameters()):
        if mode == "fp32":
            _close(p.grad, w.detach(), 2e-4, 2e-5, f"d{name}")
        else:
            assert _rel_l2(p.grad, w.detach()) < l2, f"d{name}: relative L2 {_rel_l2(p.grad, w.detach()):.3e}"


def test_lstm_bf16_policy_requires_cuda_unless_cpu_is_asked():
    """The slice's policy builds on ``device="cuda"`` by default: without a
    card it raises, and it builds on the CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    obs = {"policy": torch.zeros(2, OBS)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ActorCriticRecurrent(obs, GROUPS, ACT, dtype=torch.bfloat16, **POLICY_KW)
    policy = ActorCriticRecurrent(obs, GROUPS, ACT, device="cpu", dtype=torch.bfloat16, **POLICY_KW)
    assert policy.memory_a.rnn_type == "lstm" and policy.memory_a.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in policy.parameters())
