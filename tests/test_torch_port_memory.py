"""Memories wider than the kernels take (H > 512) against the JAX package's
``Memory``.

The port's kernels take 1 <= H <= 512. Above that, ``Memory.sequence`` and
``paired_sequence`` choose the plain step loop by shape before any launch,
as the JAX package's ``Memory.sequence_with_carry`` takes its ``lax.scan``
where the kernels' shape gate says no. On the CPU, JAX takes the scan at
every width; the port's route is checked by refusing the kernel replays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsl_rl_tpu.networks.memory import Memory as JaxMemory
from rsl_rl_tpu.networks.memory import paired_sequence as jax_paired_sequence
from rsl_rl_tpu_torch.networks import memory as port_memory
from rsl_rl_tpu_torch.networks.memory import Memory, paired_sequence
from rsl_rl_tpu_torch.utils.weights import pack_gru_cell, pack_lstm_cell

T, B, D, H = 3, 4, 7, 520
PACK = {"gru": pack_gru_cell, "lstm": pack_lstm_cell}
KERNEL_REPLAYS = ("gru_sequence", "gru_sequence_pair", "lstm_sequence_with_carry", "lstm_sequence_pair")


@pytest.fixture
def no_kernel_replay(monkeypatch):
    """Refuse every kernel replay: H > 512 must not reach one."""
    for name in KERNEL_REPLAYS:
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"H={H} was sent to the kernel replay {_name}")

        monkeypatch.setattr(port_memory, name, refuse)


def _jax_memory(family, seed):
    mem = JaxMemory(hidden_size=H, rnn_type=family, num_layers=1)
    params = mem.init(jax.random.PRNGKey(seed), mem.initialize_carry(B), jnp.zeros((B, D)))["params"]
    return mem, params


def _port_memory(family, params):
    mem = Memory(D, H, family, device="cpu")
    with torch.no_grad():
        for k, v in PACK[family](jax.device_get(params["cell_0"])).items():
            getattr(mem.cell_0, k).copy_(torch.tensor(v))
    return mem


def _inputs(family, seed):
    """``xs [T,B,D]``, ``resets [T,B]`` (a reset at t=0 and mid-window) and the
    carry leaves (``h`` or ``c, h``)."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(T, B, D)).astype(np.float32)
    resets = np.zeros((T, B), bool)
    resets[0, 0] = resets[1, 2] = resets[2, 1] = True
    leaves = [(0.5 * rng.normal(size=(B, H))).astype(np.float32) for _ in range(1 if family == "gru" else 2)]
    return xs, resets, leaves


def _carry(family, leaves):
    return (leaves[0],) if family == "gru" else ((leaves[0], leaves[1]),)


def _loss(out, lib):
    return lib.sum(out * lib.cos(out))


def _jax_replay(family, seed, data):
    """JAX ``Memory.sequence`` outputs and the gradients of a loss on them in
    the packed weights, the carry leaves and xs."""
    mem, params = _jax_memory(family, seed)
    xs, resets, leaves = data

    def loss(params, leaves, xs):
        return _loss(mem.sequence(params, _carry(family, leaves), xs, jnp.asarray(resets)), jnp)

    args = (params, [jnp.asarray(v) for v in leaves], jnp.asarray(xs))
    out = mem.sequence(params, _carry(family, args[1]), args[2], jnp.asarray(resets))
    gparams, gleaves, gxs = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return params, np.asarray(out), PACK[family](jax.device_get(gparams["cell_0"])), gleaves, gxs


def _check(got, want, grad=False):
    rtol, atol = (2e-4, 2e-5) if grad else (1e-5, 1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_wide_memory_sequence_matches_jax(family, no_kernel_replay):
    """``Memory.sequence`` at H=520: values at 1e-5, gradients at rtol 2e-4 /
    atol 2e-5; ``sequence_with_carry``'s final carry is the last step's, and
    detached."""
    data = _inputs(family, 1)
    params, want, gw, gleaves, gxs = _jax_replay(family, 0, data)
    mem = _port_memory(family, params)
    leaves = [torch.tensor(v, requires_grad=True) for v in data[2]]
    xs = torch.tensor(data[0], requires_grad=True)
    out, final = mem.sequence_with_carry(_carry(family, leaves), xs, torch.tensor(data[1]))
    _check(out, want)
    last = final[0] if family == "gru" else final[0][1]
    assert not last.requires_grad
    torch.testing.assert_close(last, out[-1].detach(), rtol=0, atol=0)
    _loss(out, torch).backward()
    for k, v in gw.items():
        _check(getattr(mem.cell_0, k).grad, v, grad=True)
    for leaf, g in zip(leaves, gleaves):
        _check(leaf.grad, g, grad=True)
    _check(xs.grad, gxs, grad=True)


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_wide_paired_sequence_matches_jax(family, no_kernel_replay):
    """``paired_sequence`` of two H=520 twins runs two plain replays, equal to
    the JAX package's ``paired_sequence``."""
    (mem_a, pa), (mem_b, pb) = _jax_memory(family, 2), _jax_memory(family, 3)
    xs, resets, leaves = _inputs(family, 4)
    ca, cb = _carry(family, [jnp.asarray(v) for v in leaves]), _carry(family, [jnp.asarray(-v) for v in leaves])
    want = jax_paired_sequence(mem_a, pa, ca, jnp.asarray(xs), mem_b, pb, cb, 2 * jnp.asarray(xs),
                               jnp.asarray(resets))
    ta, tb = _port_memory(family, pa), _port_memory(family, pb)
    tleaves = [torch.tensor(v) for v in leaves]
    got = paired_sequence(ta, _carry(family, tleaves), torch.tensor(xs), tb,
                          _carry(family, [-v for v in tleaves]), 2 * torch.tensor(xs), torch.tensor(resets))
    for g, w in zip(got, want):
        _check(g, w)


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_wide_memory_vmapped_over_seeds_matches_jax(family, no_kernel_replay):
    """Under ``torch.func.vmap`` over 2 seeds (multi-seed training), each
    seed's H=520 replay equals the JAX package's for that seed, values and
    gradients."""
    seeds = [_jax_replay(family, 10 + g, _inputs(family, 20 + g)) for g in range(2)]
    data = [_inputs(family, 20 + g) for g in range(2)]
    mem = _port_memory(family, seeds[0][0])
    packed = [PACK[family](jax.device_get(s[0]["cell_0"])) for s in seeds]
    weights = {f"cell_0.{k}": torch.tensor(np.stack([p[k] for p in packed]), requires_grad=True) for k in packed[0]}
    leaves = [torch.tensor(np.stack([d[2][i] for d in data]), requires_grad=True) for i in range(len(data[0][2]))]
    xs = torch.tensor(np.stack([d[0] for d in data]), requires_grad=True)
    resets = torch.tensor(np.stack([d[1] for d in data]))
    out = torch.func.vmap(lambda w, c, x, r: _call(mem, w, _carry(family, c), x, r))(weights, leaves, xs, resets)
    _loss(out, torch).backward()
    for g, (_, want, gw, gleaves, gxs) in enumerate(seeds):
        _check(out[g], want)
        for k, v in gw.items():
            _check(weights[f"cell_0.{k}"].grad[g], v, grad=True)
        for leaf, w in zip(leaves, gleaves):
            _check(leaf.grad[g], w, grad=True)
        _check(xs.grad[g], gxs, grad=True)


class _Sequence(torch.nn.Module):
    def __init__(self, mem):
        super().__init__()
        self.mem = mem

    def forward(self, carry0, xs, resets):
        return self.mem.sequence(carry0, xs, resets)


def _call(mem, weights, carry0, xs, resets):
    state = {f"mem.{k}": v for k, v in weights.items()}
    return torch.func.functional_call(_Sequence(mem), state, (carry0, xs, resets))
