"""The port's LSTM replay (``rsl_rl_tpu_torch.ops.lstm_rnn``) and LSTM
``Memory`` against the JAX package's Pallas LSTM kernels, run in Pallas
interpret mode on the CPU as ``tests/test_pallas_rnn.py`` runs them.

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
from rsl_rl_tpu_torch.networks.memory import Memory, mask_carry, memory_sequence, paired_sequence
from rsl_rl_tpu_torch.ops import lstm_rnn
from rsl_rl_tpu_torch.utils.weights import pack_lstm_cell

T, B, D, H = 6, 128, 15, 128


def _jax_cells(seed, d=D, num_layers=1):
    mem = JaxMemory(hidden_size=H, rnn_type="lstm", num_layers=num_layers)
    return mem, mem.init(jax.random.PRNGKey(seed), mem.initialize_carry(B), jnp.zeros((B, d)))["params"]


def _inputs(seed, t=T):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(t, B, D)).astype(np.float32)
    resets = rng.random((t, B)) < 0.15
    resets[0] = False
    c0 = rng.normal(size=(B, H)).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(B, H))).astype(np.float32)
    return xs, resets, (c0, h0)


def _torch_params(cell):
    return {k: torch.tensor(v, requires_grad=True) for k, v in pack_lstm_cell(jax.device_get(cell)).items()}


def _torch_carry(carry):
    return tuple(torch.tensor(c, requires_grad=True) for c in carry)


def _jax_carry(carry):
    return tuple(jnp.asarray(c) for c in carry)


def _load(mem, params):
    with torch.no_grad():
        for layer in range(mem.num_layers):
            for k, v in pack_lstm_cell(jax.device_get(params[f"cell_{layer}"])).items():
                getattr(getattr(mem, f"cell_{layer}"), k).copy_(torch.tensor(v))


def _loss_jax(out):
    return jnp.sum(out * jnp.cos(out))


def _loss_torch(out):
    return torch.sum(out * torch.cos(out))


def _assert_close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got.detach().numpy().astype(np.float64) - want) / (np.linalg.norm(want) + 1e-6)


def _grads(p, carry, x, gcell, gcarry, gxs):
    """``{name: (port grad, JAX grad)}`` of the packed weights, c0, h0 and xs."""
    out = {f"d{k}": (p[k].grad, v) for k, v in pack_lstm_cell(jax.device_get(gcell)).items()}
    out.update({"dc0": (carry[0].grad, gcarry[0]), "dh0": (carry[1].grad, gcarry[1]), "dxs": (x.grad, gxs)})
    return out


@pytest.mark.parametrize("t", [T, 1], ids=["T6", "T1"])
def test_values_and_grads_match_pallas(t):
    """fp32: values at rtol/atol 1e-5 and gradients of wx, wh, bh, c0, h0 and
    xs at rtol 2e-4 / atol 2e-5, the bars of tests/test_pallas_rnn.py."""
    _, params = _jax_cells(0)
    cell = params["cell_0"]
    xs, resets, carry = _inputs(1, t)

    def jax_loss(cell, carry, xs):
        return _loss_jax(pallas_rnn.lstm_sequence(cell, carry, xs, jnp.asarray(resets)))

    with pltpu.force_tpu_interpret_mode():
        want = pallas_rnn.lstm_sequence(cell, _jax_carry(carry), jnp.asarray(xs), jnp.asarray(resets))
        gcell, gcarry, gxs = jax.grad(jax_loss, argnums=(0, 1, 2))(cell, _jax_carry(carry), jnp.asarray(xs))

    p, tc = _torch_params(cell), _torch_carry(carry)
    x = torch.tensor(xs, requires_grad=True)
    got = lstm_rnn.lstm_sequence_x(p, tc, x, torch.tensor(resets))
    _assert_close(got, want, 1e-5, 1e-5, "hs")
    _loss_torch(got).backward()
    for name, (g, w) in _grads(p, tc, x, gcell, gcarry, gxs).items():
        _assert_close(g, w, 2e-4, 2e-5, name)


def test_wide_hidden_matches_pallas():
    """H=384, above the 256 the port's kernels once took: the x-streaming
    replay's values and gradients against the Pallas LSTM kernel, at the fp32
    bars of test_values_and_grads_match_pallas."""
    h, t = 384, 4
    mem = JaxMemory(hidden_size=h, rnn_type="lstm")
    cell = mem.init(jax.random.PRNGKey(30), mem.initialize_carry(B), jnp.zeros((B, D)))["params"]["cell_0"]
    rng = np.random.default_rng(31)
    xs = rng.normal(size=(t, B, D)).astype(np.float32)
    resets = rng.random((t, B)) < 0.15
    resets[0] = False
    carry = (rng.normal(size=(B, h)).astype(np.float32), (0.5 * rng.normal(size=(B, h))).astype(np.float32))

    def jax_loss(cell, carry, xs):
        return _loss_jax(pallas_rnn.lstm_sequence(cell, carry, xs, jnp.asarray(resets)))

    with pltpu.force_tpu_interpret_mode():
        want = pallas_rnn.lstm_sequence(cell, _jax_carry(carry), jnp.asarray(xs), jnp.asarray(resets))
        gcell, gcarry, gxs = jax.grad(jax_loss, argnums=(0, 1, 2))(cell, _jax_carry(carry), jnp.asarray(xs))

    p, tc = _torch_params(cell), _torch_carry(carry)
    x = torch.tensor(xs, requires_grad=True)
    got = lstm_rnn.lstm_sequence_x(p, tc, x, torch.tensor(resets))
    _assert_close(got, want, 1e-5, 1e-5, "hs")
    _loss_torch(got).backward()
    for name, (g, w) in _grads(p, tc, x, gcell, gcarry, gxs).items():
        _assert_close(g, w, 2e-4, 2e-5, name)


def test_pair_matches_pallas_pair():
    """The stream-paired replay: values and gradients of both streams."""
    _, pa = _jax_cells(2)
    _, pb = _jax_cells(3)
    xs_a, resets, c_a = _inputs(4)
    xs_b, _, c_b = _inputs(5)
    cells = (pa["cell_0"], pb["cell_0"])

    def jax_loss(cells, carries, xss):
        ha, hb = pallas_rnn.lstm_sequence_pair(cells, carries, xss, jnp.asarray(resets))
        return _loss_jax(ha) + 0.5 * _loss_jax(hb)

    jc = (_jax_carry(c_a), _jax_carry(c_b))
    jx = (jnp.asarray(xs_a), jnp.asarray(xs_b))
    with pltpu.force_tpu_interpret_mode():
        want = pallas_rnn.lstm_sequence_pair(cells, jc, jx, jnp.asarray(resets))
        gcells, gcarries, gxs = jax.grad(jax_loss, argnums=(0, 1, 2))(cells, jc, jx)

    params = (_torch_params(cells[0]), _torch_params(cells[1]))
    carries = (_torch_carry(c_a), _torch_carry(c_b))
    xss = tuple(torch.tensor(x, requires_grad=True) for x in (xs_a, xs_b))
    got = lstm_rnn.lstm_sequence_pair(params, carries, xss, torch.tensor(resets))
    for s in range(2):
        _assert_close(got[s], want[s], 1e-5, 1e-5, f"stream {s} hs")
    (_loss_torch(got[0]) + 0.5 * _loss_torch(got[1])).backward()
    for s in range(2):
        for name, (g, w) in _grads(params[s], carries[s], xss[s], gcells[s], gcarries[s], gxs[s]).items():
            _assert_close(g, w, 2e-4, 2e-5, f"stream {s} {name}")


def test_bf16_operands_match_pallas_bf16():
    """bf16 matmul operands with fp32 accumulation: the same scheme on both
    sides, so values hold the repo's same-scheme bar (rtol 1e-3 / atol 5e-4,
    tests/test_pallas_rnn.py) and gradients a relative L2 error of 1e-2,
    well under the 5e-2 that separates bf16 from fp32 there."""
    _, params = _jax_cells(6)
    cell = params["cell_0"]
    xs, resets, carry = _inputs(7)

    def jax_loss(cell, carry, xs):
        out = pallas_rnn.lstm_sequence(cell, carry, xs, jnp.asarray(resets), compute_dtype=jnp.bfloat16)
        return _loss_jax(out)

    with pltpu.force_tpu_interpret_mode():
        want = pallas_rnn.lstm_sequence(cell, _jax_carry(carry), jnp.asarray(xs), jnp.asarray(resets),
                                        compute_dtype=jnp.bfloat16)
        gcell, gcarry, gxs = jax.grad(jax_loss, argnums=(0, 1, 2))(cell, _jax_carry(carry), jnp.asarray(xs))

    p, tc = _torch_params(cell), _torch_carry(carry)
    x = torch.tensor(xs, requires_grad=True)
    got = lstm_rnn.lstm_sequence_x(p, tc, x, torch.tensor(resets), compute_dtype=torch.bfloat16)
    _assert_close(got, want, 1e-3, 5e-4, "hs")
    _loss_torch(got).backward()
    for name, (g, w) in _grads(p, tc, x, gcell, gcarry, gxs).items():
        assert _rel_l2(g, w) < 1e-2, f"{name}: relative L2 {_rel_l2(g, w):.3e}"


def test_sequence_with_carry_matches_pallas():
    """The value-only final ``(cT, hT)`` of ``lstm_sequence_with_carry``."""
    _, params = _jax_cells(8)
    cell = params["cell_0"]
    xs, resets, carry = _inputs(9)
    with pltpu.force_tpu_interpret_mode():
        want, (want_c, want_h) = pallas_rnn.lstm_sequence_with_carry(
            cell, _jax_carry(carry), jnp.asarray(xs), jnp.asarray(resets))
    got, (got_c, got_h) = lstm_rnn.lstm_sequence_with_carry(
        _torch_params(cell), _torch_carry(carry), torch.tensor(xs), torch.tensor(resets))
    _assert_close(got, want, 1e-5, 1e-5, "hs")
    assert not got_c.requires_grad and not got_h.requires_grad
    _assert_close(got_c, want_c, 1e-5, 1e-5, "cT")
    _assert_close(got_h, want_h, 1e-5, 1e-5, "hT")


def test_two_layer_memory_matches_pallas_and_scan():
    """Two stacked layers: the port's Memory.sequence against two chained
    Pallas calls (values and grads), its step-by-step acting replay against
    the JAX scan path, and Memory.sequence_with_carry's final carries
    against the JAX Memory's."""
    jmem, params = _jax_cells(10, num_layers=2)
    xs, resets, carry0 = _inputs(11)
    _, _, carry1 = _inputs(12)
    jcarry = (_jax_carry(carry0), _jax_carry(carry1))

    def jax_loss(params, xs):
        out = xs
        for layer in range(2):
            out = pallas_rnn.lstm_sequence(params[f"cell_{layer}"], jcarry[layer], out, jnp.asarray(resets))
        return _loss_jax(out)

    with pltpu.force_tpu_interpret_mode():
        gparams, gxs = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(xs))
    apply_step = lambda c, x: jmem.apply({"params": params}, c, x)  # noqa: E731
    want = jax_memory_sequence(apply_step, jcarry, jnp.asarray(xs), jnp.asarray(resets))
    _, want_finals = jmem.sequence_with_carry(params, jcarry, jnp.asarray(xs), jnp.asarray(resets))

    mem = Memory(D, H, "lstm", num_layers=2, device="cpu")
    _load(mem, params)
    carry = tuple(tuple(torch.tensor(c) for c in layer) for layer in (carry0, carry1))
    x = torch.tensor(xs, requires_grad=True)
    got, finals = mem.sequence_with_carry(carry, x, torch.tensor(resets))
    _assert_close(got, want, 1e-5, 1e-5, "two-layer hs vs scan")
    _assert_close(memory_sequence(mem, carry, torch.tensor(xs), torch.tensor(resets)), want,
                  1e-5, 1e-5, "acting replay vs scan")
    for layer in range(2):
        for k, name in enumerate("ch"):
            _assert_close(finals[layer][k], want_finals[layer][k], 1e-5, 1e-5, f"layer {layer} final {name}")
    _loss_torch(got).backward()
    for layer in range(2):
        cell = getattr(mem, f"cell_{layer}")
        for k, v in pack_lstm_cell(jax.device_get(gparams[f"cell_{layer}"])).items():
            _assert_close(getattr(cell, k).grad, v, 5e-4, 5e-5, f"layer {layer} d{k}")
    _assert_close(x.grad, gxs, 5e-4, 5e-5, "dxs")


def test_paired_sequence_pairs_lstm_twins_and_not_gru_with_lstm():
    """LSTM twins take the stream-paired replay and equal two sequences; a
    GRU and an LSTM of one width and depth are no twins and take two
    sequences (the JAX package's twins test compares rnn_type too)."""
    torch.manual_seed(0)
    xs, resets, carry = _inputs(13)
    xs, resets = torch.tensor(xs), torch.tensor(resets)
    lstm_carry = (tuple(torch.tensor(c) for c in carry),)
    mem_a = Memory(D, H, "lstm", device="cpu")
    mem_b = Memory(D, H, "lstm", device="cpu")
    pa, pb = paired_sequence(mem_a, lstm_carry, xs, mem_b, lstm_carry, 2 * xs, resets)
    torch.testing.assert_close(pa, mem_a.sequence(lstm_carry, xs, resets), rtol=0, atol=0)
    torch.testing.assert_close(pb, mem_b.sequence(lstm_carry, 2 * xs, resets), rtol=0, atol=0)

    gru = Memory(D, H, "gru", device="cpu")
    gru_carry = (torch.tensor(carry[1]),)
    pa, pb = paired_sequence(gru, gru_carry, xs, mem_b, lstm_carry, xs, resets)
    torch.testing.assert_close(pa, gru.sequence(gru_carry, xs, resets), rtol=0, atol=0)
    torch.testing.assert_close(pb, mem_b.sequence(lstm_carry, xs, resets), rtol=0, atol=0)


def test_mask_carry_walks_nested_carries():
    """An LSTM carry is a tuple of ``(c, h)`` per layer: every leaf is masked."""
    rng = np.random.default_rng(14)
    carry = tuple(tuple(torch.tensor(rng.normal(size=(4, 3)).astype(np.float32)) for _ in range(2))
                  for _ in range(2))
    mask = torch.tensor([True, False, True, False])
    masked = mask_carry(carry, mask)
    assert len(masked) == 2 and all(len(layer) == 2 for layer in masked)
    for layer, want_layer in zip(masked, carry):
        for got, want in zip(layer, want_layer):
            torch.testing.assert_close(got[~mask], want[~mask], rtol=0, atol=0)
            assert torch.all(got[mask] == 0)
