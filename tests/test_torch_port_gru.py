"""The port's GRU replay (``rsl_rl_tpu_torch.ops.gru_rnn``) against the JAX
package's Pallas GRU kernels, run in Pallas interpret mode on the CPU as
``tests/test_pallas_rnn.py`` runs them.

On the CPU the port's wrappers take their plain version; the CUDA kernels are
held against that plain version on the card (``tests/test_torch_port_kernels.py``
and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsl_rl_tpu.networks.memory import Memory as JaxMemory
from rsl_rl_tpu.networks.memory import memory_sequence as jax_memory_sequence
from rsl_rl_tpu.ops import pallas_rnn
from rsl_rl_tpu_torch.networks.memory import Memory, memory_sequence, paired_sequence
from rsl_rl_tpu_torch.ops import gru_rnn
from rsl_rl_tpu_torch.utils.weights import pack_gru_cell

T, B, D, H = 6, 128, 12, 128


def _jax_cells(seed, d, num_layers=1):
    mem = JaxMemory(hidden_size=H, rnn_type="gru", num_layers=num_layers)
    return mem, mem.init(jax.random.PRNGKey(seed), mem.initialize_carry(B), jnp.zeros((B, d)))["params"]


def _inputs(seed, t=T, d=D):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(t, B, d)).astype(np.float32)
    resets = rng.random((t, B)) < 0.15
    resets[0] = False
    carry0 = rng.normal(size=(B, H)).astype(np.float32)
    return xs, resets, carry0


def _torch_params(cell):
    return {k: torch.tensor(v, requires_grad=True) for k, v in pack_gru_cell(jax.device_get(cell)).items()}


def _loss_jax(out):
    return jnp.sum(out * jnp.cos(out))


def _loss_torch(out):
    return torch.sum(out * torch.cos(out))


def _assert_close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got.detach().numpy().astype(np.float64) - want) / (np.linalg.norm(want) + 1e-6)


@pytest.mark.parametrize("t", [T, 1], ids=["T6", "T1"])
def test_values_and_grads_match_pallas(t):
    """fp32: values at rtol/atol 1e-5 and gradients of params, carry0 and xs
    at rtol 2e-4 / atol 2e-5, the bars of tests/test_pallas_rnn.py."""
    _, params = _jax_cells(0, D)
    cell = params["cell_0"]
    xs, resets, carry0 = _inputs(1, t)

    def jax_loss(cell, carry0, xs):
        return _loss_jax(pallas_rnn.gru_sequence(cell, carry0, xs, jnp.asarray(resets)))

    with pltpu.force_tpu_interpret_mode():
        want = pallas_rnn.gru_sequence(cell, jnp.asarray(carry0), jnp.asarray(xs), jnp.asarray(resets))
        gcell, gcarry, gxs = jax.grad(jax_loss, argnums=(0, 1, 2))(cell, jnp.asarray(carry0), jnp.asarray(xs))

    p = _torch_params(cell)
    c0 = torch.tensor(carry0, requires_grad=True)
    x = torch.tensor(xs, requires_grad=True)
    got = gru_rnn.gru_sequence_x(p, c0, x, torch.tensor(resets))
    _assert_close(got, want, 1e-5, 1e-5, "hs")
    _loss_torch(got).backward()
    for k, v in pack_gru_cell(jax.device_get(gcell)).items():
        _assert_close(p[k].grad, v, 2e-4, 2e-5, f"d{k}")
    _assert_close(c0.grad, gcarry, 2e-4, 2e-5, "dcarry0")
    _assert_close(x.grad, gxs, 2e-4, 2e-5, "dxs")


def test_pair_matches_pallas_pair():
    """The stream-paired replay: values and gradients of both streams."""
    _, pa = _jax_cells(2, D)
    _, pb = _jax_cells(3, D)
    xs_a, resets, c_a = _inputs(4)
    xs_b, _, c_b = _inputs(5)
    cells = (pa["cell_0"], pb["cell_0"])

    def jax_loss(cells, carries, xss):
        ha, hb = pallas_rnn.gru_sequence_pair(cells, carries, xss, jnp.asarray(resets))
        return _loss_jax(ha) + 0.5 * _loss_jax(hb)

    jc = (jnp.asarray(c_a), jnp.asarray(c_b))
    jx = (jnp.asarray(xs_a), jnp.asarray(xs_b))
    with pltpu.force_tpu_interpret_mode():
        want_a, want_b = pallas_rnn.gru_sequence_pair(cells, jc, jx, jnp.asarray(resets))
        gcells, gcarries, gxs = jax.grad(jax_loss, argnums=(0, 1, 2))(cells, jc, jx)

    params = (_torch_params(cells[0]), _torch_params(cells[1]))
    carries = tuple(torch.tensor(c, requires_grad=True) for c in (c_a, c_b))
    xss = tuple(torch.tensor(x, requires_grad=True) for x in (xs_a, xs_b))
    got_a, got_b = gru_rnn.gru_sequence_pair(params, carries, xss, torch.tensor(resets))
    _assert_close(got_a, want_a, 1e-5, 1e-5, "hs_a")
    _assert_close(got_b, want_b, 1e-5, 1e-5, "hs_b")
    (_loss_torch(got_a) + 0.5 * _loss_torch(got_b)).backward()
    for s in range(2):
        for k, v in pack_gru_cell(jax.device_get(gcells[s])).items():
            _assert_close(params[s][k].grad, v, 2e-4, 2e-5, f"stream {s} d{k}")
        _assert_close(carries[s].grad, gcarries[s], 2e-4, 2e-5, f"stream {s} dcarry0")
        _assert_close(xss[s].grad, gxs[s], 2e-4, 2e-5, f"stream {s} dxs")


def test_bf16_operands_match_pallas_bf16():
    """bf16 matmul operands with fp32 accumulation: the same scheme on both
    sides, so values hold the repo's same-scheme bar (rtol 1e-3 / atol 5e-4,
    tests/test_pallas_rnn.py) and gradients a relative L2 error of 1e-2,
    well under the 5e-2 that separates bf16 from fp32 there."""
    _, params = _jax_cells(6, D)
    cell = params["cell_0"]
    xs, resets, carry0 = _inputs(7)

    def jax_loss(cell, carry0, xs):
        out = pallas_rnn.gru_sequence(cell, carry0, xs, jnp.asarray(resets), compute_dtype=jnp.bfloat16)
        return _loss_jax(out)

    with pltpu.force_tpu_interpret_mode():
        want = pallas_rnn.gru_sequence(cell, jnp.asarray(carry0), jnp.asarray(xs), jnp.asarray(resets),
                                       compute_dtype=jnp.bfloat16)
        gcell, gcarry, gxs = jax.grad(jax_loss, argnums=(0, 1, 2))(cell, jnp.asarray(carry0), jnp.asarray(xs))

    p = _torch_params(cell)
    c0 = torch.tensor(carry0, requires_grad=True)
    x = torch.tensor(xs, requires_grad=True)
    got = gru_rnn.gru_sequence_x(p, c0, x, torch.tensor(resets), compute_dtype=torch.bfloat16)
    _assert_close(got, want, 1e-3, 5e-4, "hs")
    _loss_torch(got).backward()
    grads = {**{f"d{k}": (p[k].grad, v) for k, v in pack_gru_cell(jax.device_get(gcell)).items()},
             "dcarry0": (c0.grad, gcarry), "dxs": (x.grad, gxs)}
    for name, (g, w) in grads.items():
        assert _rel_l2(g, w) < 1e-2, f"{name}: relative L2 {_rel_l2(g, w):.3e}"


def test_two_layer_memory_matches_pallas_and_scan():
    """Two stacked layers: the port's Memory.sequence against two chained
    Pallas calls (values and grads), and its step-by-step acting replay
    against the JAX scan path."""
    jmem, params = _jax_cells(8, D, num_layers=2)
    xs, resets, c0 = _inputs(9)
    c1 = np.random.default_rng(10).normal(size=(B, H)).astype(np.float32)
    jcarry = (jnp.asarray(c0), jnp.asarray(c1))

    def jax_loss(params, xs):
        out = xs
        for layer in range(2):
            out = pallas_rnn.gru_sequence(params[f"cell_{layer}"], jcarry[layer], out, jnp.asarray(resets))
        return _loss_jax(out)

    with pltpu.force_tpu_interpret_mode():
        gparams, gxs = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(xs))
    apply_step = lambda c, x: jmem.apply({"params": params}, c, x)  # noqa: E731
    want = jax_memory_sequence(apply_step, jcarry, jnp.asarray(xs), jnp.asarray(resets))

    mem = Memory(D, H, "gru", num_layers=2, device="cpu")
    with torch.no_grad():
        for layer in range(2):
            for k, v in pack_gru_cell(jax.device_get(params[f"cell_{layer}"])).items():
                getattr(getattr(mem, f"cell_{layer}"), k).copy_(torch.tensor(v))
    carry = (torch.tensor(c0), torch.tensor(c1))
    x = torch.tensor(xs, requires_grad=True)
    got = mem.sequence(carry, x, torch.tensor(resets))
    _assert_close(got, want, 1e-5, 1e-5, "two-layer hs vs scan")
    _assert_close(memory_sequence(mem, carry, torch.tensor(xs), torch.tensor(resets)), want,
                  1e-5, 1e-5, "acting replay vs scan")
    _loss_torch(got).backward()
    for layer in range(2):
        cell = getattr(mem, f"cell_{layer}")
        for k, v in pack_gru_cell(jax.device_get(gparams[f"cell_{layer}"])).items():
            _assert_close(getattr(cell, k).grad, v, 5e-4, 5e-5, f"layer {layer} d{k}")
    _assert_close(x.grad, gxs, 5e-4, 5e-5, "dxs")


def test_sequence_with_carry_matches_jax():
    """Two layers: the replay and the value-only carry after the last step."""
    jmem, params = _jax_cells(14, D, num_layers=2)
    xs, resets, c0 = _inputs(15)
    c1 = np.random.default_rng(16).normal(size=(B, H)).astype(np.float32)
    want, want_finals = jmem.sequence_with_carry(
        params, (jnp.asarray(c0), jnp.asarray(c1)), jnp.asarray(xs), jnp.asarray(resets))

    mem = Memory(D, H, "gru", num_layers=2, device="cpu")
    with torch.no_grad():
        for layer in range(2):
            for k, v in pack_gru_cell(jax.device_get(params[f"cell_{layer}"])).items():
                getattr(getattr(mem, f"cell_{layer}"), k).copy_(torch.tensor(v))
    got, finals = mem.sequence_with_carry((torch.tensor(c0), torch.tensor(c1)), torch.tensor(xs),
                                          torch.tensor(resets))
    _assert_close(got, want, 1e-5, 1e-5, "hs")
    assert len(finals) == 2
    for layer in range(2):
        assert not finals[layer].requires_grad
        _assert_close(finals[layer], want_finals[layer], 1e-5, 1e-5, f"layer {layer} final carry")


def test_paired_sequence_equals_two_sequences():
    torch.manual_seed(0)
    mem_a = Memory(D, H, "gru", device="cpu")
    mem_b = Memory(D, H, "gru", device="cpu")
    xs, resets, c0 = _inputs(11)
    xs, resets, c0 = torch.tensor(xs), torch.tensor(resets), (torch.tensor(c0),)
    pa, pb = paired_sequence(mem_a, c0, xs, mem_b, c0, 2 * xs, resets)
    torch.testing.assert_close(pa, mem_a.sequence(c0, xs, resets), rtol=0, atol=0)
    torch.testing.assert_close(pb, mem_b.sequence(c0, 2 * xs, resets), rtol=0, atol=0)


def test_lstm_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Memory(D, H, "lstm", device="cpu")
