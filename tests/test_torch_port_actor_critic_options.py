"""The port's actor-critic options against the JAX package: the
state-dependent std of ``ActorCritic`` and ``ActorCriticRecurrent`` (scalar
and log modes, fp32 and a bf16 trunk), its init, one PPO update with it, and
``MLP(init_scales=)``.

JAX runs on the CPU; both sides start from the same weights
(``utils/weights.py`` maps the actor's ``[H, 2A]`` head). Bars: fp32 at
rtol 1e-5 / atol 1e-5, bf16 at rtol 5e-2 / atol 3e-2 (the bars of
``tests/test_torch_port_bf16.py``: bf16 rounds at other places in XLA and in
PyTorch), one update at rtol 3e-4 / atol 3e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu.modules import ActorCritic as JaxAC
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState
from rsl_rl_tpu_torch.modules import ActorCritic, ActorCriticRecurrent
from rsl_rl_tpu_torch.networks.mlp import MLP
from rsl_rl_tpu_torch.storage.rollout import Rollout, tree_map
from rsl_rl_tpu_torch.utils.weights import from_jax_state

N, LINKS, T = 16, 3, 8
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
MLP_KW = dict(actor_hidden_dims=[16, 16], critic_hidden_dims=[16, 16], actor_obs_normalization=True,
              critic_obs_normalization=True, state_dependent_std=True, init_noise_std=0.8)
POLICIES = {"feedforward": (JaxAC, ActorCritic, MLP_KW),
            "gru": (JaxACR, ActorCriticRecurrent, dict(MLP_KW, rnn_type="gru", rnn_hidden_dim=16))}
DTYPES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
BARS = {"fp32": (1e-5, 1e-5), "bf16": (5e-2, 3e-2)}


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _norm_np(norm):
    return {k: None if v is None else {f: np.asarray(getattr(v, f)) for f in ("mean", "var", "count")}
            for k, v in norm.items()}


def _pair(name, std_type, dtype="fp32", seed=0):
    """A JAX policy and its state, and the port's policy holding that state."""
    jcls, cls, kw = POLICIES[name]
    env = JaxNLink(N, LINKS)
    _, obs = env.reset(jax.random.PRNGKey(seed))
    jd, td = DTYPES[dtype]
    jpolicy = jcls(obs, GROUPS, LINKS, noise_std_type=std_type, dtype=jd, **kw)
    ps = jpolicy.update_normalization(jpolicy.init(jax.random.PRNGKey(seed + 1)), obs)
    policy = cls({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS, device="cpu", noise_std_type=std_type,
                 dtype=td, **kw)
    psn = jax.device_get(ps)
    from_jax_state(psn.params, _norm_np(psn.norm), policy)
    return jpolicy, ps, policy, obs


@pytest.mark.parametrize("std_type", ["scalar", "log"])
def test_state_dependent_std_init(std_type):
    """The actor's head outputs ``[2, A]``; its std half starts at zero
    weights and a bias of ``init_noise_std`` (scalar) or ``log(init_noise_std
    + 1e-7)`` (log), as the JAX init sets it; no std parameter exists."""
    jpolicy, ps, _, obs = _pair("feedforward", std_type)
    policy = ActorCritic({k: _t(v) for k, v in obs.items()}, GROUPS, LINKS, device="cpu", noise_std_type=std_type,
                         **MLP_KW)
    assert policy.std is None and "std" not in dict(policy.named_parameters())
    head = policy.actor.dense_2
    assert head.weight.shape == (2 * LINKS, 16)
    want_bias = 0.8 if std_type == "scalar" else math.log(0.8 + 1e-7)
    assert torch.equal(head.weight[LINKS:], torch.zeros(LINKS, 16))
    np.testing.assert_allclose(head.bias[LINKS:].detach().numpy(), want_bias, rtol=1e-7)
    jhead = jax.device_get(ps.params["actor"]["dense_2"])
    assert np.all(jhead["kernel"][:, LINKS:] == 0) and ps.params["std"] is None
    np.testing.assert_allclose(jhead["bias"][LINKS:], want_bias, rtol=1e-6)
    _, std, _ = policy.act({k: _t(v) for k, v in obs.items()}, ())
    np.testing.assert_allclose(std.detach().numpy(), 0.8, rtol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("std_type", ["scalar", "log"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_state_dependent_std_matches_jax(name, std_type, dtype):
    """``act``, ``act_inference`` and the update's ``act_value_seq`` (a
    window with resets for the GRU policy) against JAX from the same weights
    (the std half of the head trained away from its init), in fp32 and with a
    bf16 trunk (the head stays fp32)."""
    jpolicy, ps, policy, obs = _pair(name, std_type, dtype)
    rng = np.random.default_rng(2)
    head = ps.params["actor"]["dense_2"]
    head = {"kernel": head["kernel"] + 0.1 * rng.normal(size=head["kernel"].shape).astype(np.float32),
            "bias": head["bias"]}
    ps = ps.replace(params={**ps.params, "actor": {**ps.params["actor"], "dense_2": head}})
    psn = jax.device_get(ps)
    from_jax_state(psn.params, _norm_np(psn.norm), policy)
    rtol, atol = BARS[dtype]
    carry = jpolicy.initial_carry(N)
    tobs = {k: _t(v) for k, v in obs.items()}
    tcarry = tree_map(_t, jax.device_get(carry))
    mean, std, _ = jpolicy.act(ps, obs, carry)
    tmean, tstd, _ = policy.act(tobs, tcarry)
    _close(tmean, mean, rtol, atol, "act mean")
    _close(tstd, std, rtol, atol, "act std")
    assert not np.allclose(np.asarray(std), np.asarray(std)[0, 0]), "want a state-dependent std"
    inf, _ = jpolicy.act_inference(ps, obs, carry)
    _close(policy.act_inference(tobs, tcarry)[0], inf, rtol, atol, "act_inference")
    seq = {"policy": rng.normal(size=(T, N, 3 * LINKS)).astype(np.float32)}
    resets = rng.random((T, N)) < 0.2
    resets[0] = False
    want = jpolicy.act_value_seq(ps, seq, carry, jnp.asarray(resets))
    got = policy.act_value_seq({k: _t(v) for k, v in seq.items()}, tcarry, _t(resets))
    for what, g, w in zip(("mean", "std", "value"), got, want):
        _close(g, w, rtol, atol, f"act_value_seq {what}")


def test_state_dependent_std_update_matches_jax():
    """One recurrent PPO update (log-mode state-dependent std) on a JAX-made
    window with dones: every metric and every updated parameter, the std
    half of the head among them."""
    env = JaxNLink(N, LINKS, max_episode_length=5)
    _, obs = env.reset(jax.random.PRNGKey(0))
    kw = dict(POLICIES["gru"][2], noise_std_type="log")
    jppo = JaxPPO(JaxACR(obs, GROUPS, LINKS, **kw), num_learning_epochs=2, num_mini_batches=2)
    ts0 = jppo.init_train_state(jax.random.PRNGKey(1), N)
    cs0 = jppo.init_collect_state(jax.random.PRNGKey(2), env)
    cs0 = cs0.replace(env_state=env.randomize_episode_length(cs0.env_state, jax.random.PRNGKey(3)))
    ts1, cs1, rollout, _ = jax.jit(jppo.make_collect_fn(env, T))(ts0, cs0)
    assert np.asarray(rollout.dones).any()
    ts2, _, um = jax.jit(jppo.make_update_fn())(ts1, cs1, rollout)

    def port(ts):
        policy = ActorCriticRecurrent({k: _t(v) for k, v in cs1.obs.items()}, GROUPS, LINKS, device="cpu", **kw)
        ps = jax.device_get(ts.policy)
        from_jax_state(ps.params, _norm_np(ps.norm), policy)
        return policy

    policy = port(ts1)
    ppo = PPO(policy, num_learning_epochs=2, num_mini_batches=2)
    cs = CollectState(env_state=None, obs={k: _t(v) for k, v in cs1.obs.items()},
                      carry=tree_map(_t, jax.device_get(cs1.carry)), stats=None)
    port_rollout = Rollout(
        obs={k: _t(v) for k, v in rollout.obs.items()}, actions=_t(rollout.actions), rewards=_t(rollout.rewards),
        dones=_t(rollout.dones), values=_t(rollout.values), log_probs=_t(rollout.log_probs), mu=_t(rollout.mu),
        sigma=_t(rollout.sigma), carry0=tree_map(_t, jax.device_get(rollout.carry0)))
    _, metrics = ppo.update(cs, port_rollout)
    um = jax.device_get(um)
    assert set(metrics) == set(um)
    for k in um:
        _close(metrics[k], um[k], 3e-4, 3e-5, f"metric {k}")
    want = port(ts2)
    for (n, p), (_, w) in zip(policy.named_parameters(), want.named_parameters()):
        _close(p, w, 3e-4, 3e-5, f"updated {n}")
    head0 = port(ts1).actor.dense_2.weight[LINKS:]
    assert not torch.equal(policy.actor.dense_2.weight[LINKS:], head0), "the std half trained"


@pytest.mark.parametrize("scales", [1.0, [2.0 ** 0.5, 2.0 ** 0.5, 0.01]], ids=["one_gain", "a_gain_a_layer"])
def test_init_scales_orthogonal(scales):
    """``init_scales`` draws orthogonal weights with each layer's gain (the
    smaller Gram matrix is ``gain^2 I``) and zero biases; a list of the wrong
    length raises."""
    gen = torch.Generator().manual_seed(0)
    mlp = MLP(12, 3, [32, 8], "elu", gen, init_scales=scales)
    gains = scales if isinstance(scales, list) else [scales] * 3
    for i, gain in enumerate(gains):
        layer = getattr(mlp, f"dense_{i}")
        w = layer.weight.detach().double()
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(gram.shape[0]), atol=1e-5 * max(1, gain ** 2))
        assert torch.equal(layer.bias, torch.zeros_like(layer.bias))
    again = MLP(12, 3, [32, 8], "elu", torch.Generator().manual_seed(0), init_scales=scales)
    assert all(torch.equal(a, b) for a, b in zip(mlp.parameters(), again.parameters()))
    with pytest.raises(ValueError, match="init_scales"):
        MLP(12, 3, [32, 8], "elu", gen, init_scales=[1.0, 1.0])


def test_tuple_output_reshapes():
    mlp = MLP(5, (2, 3), [4], "elu", torch.Generator().manual_seed(1))
    assert mlp(torch.zeros(7, 5)).shape == (7, 2, 3) and mlp.dense_1.weight.shape == (6, 4)
