"""The port's xproj replay (``gru_sequence_xproj`` / ``lstm_sequence_xproj``
and the wide-input routing of ``Memory`` and ``paired_sequence``) against the
JAX package's xproj-streaming Pallas cores (``_gru_core`` / ``_lstm_core``),
run in Pallas interpret mode on the CPU as ``tests/test_pallas_rnn.py`` runs
them.

Inputs wider than 512 take the xproj cores in both packages. The seed-axis
replay (G streams, each with its own weights, carry and resets) is held
against the JAX core called once per seed: a batched grid cannot run in
interpret mode (``tests/test_multiseed.py``). On the CPU the port's wrappers
take their plain version; the CUDA kernels are held against it on the card
(``tests/test_torch_port_kernels.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsl_rl_tpu.networks.memory import Memory as JaxMemory
from rsl_rl_tpu.ops import pallas_rnn
from rsl_rl_tpu_torch.networks import memory as port_memory
from rsl_rl_tpu_torch.networks.memory import Memory, paired_sequence
from rsl_rl_tpu_torch.ops import gru_rnn, lstm_rnn
from rsl_rl_tpu_torch.storage.rollout import tree_map
from rsl_rl_tpu_torch.utils.weights import pack_gru_cell, pack_lstm_cell

T, B, H = 6, 128, 128
WIDE, NARROW = 520, 12
PACK = {"gru": pack_gru_cell, "lstm": pack_lstm_cell}
# bf16 operands on both sides: the same-scheme bars of tests/test_torch_port_gru.py
BF16_VALUES = (1e-3, 5e-4)
BF16_GRAD_REL_L2 = 1e-2


def _jax_cell(family, seed, d):
    mem = JaxMemory(hidden_size=H, rnn_type=family, num_layers=1)
    return mem.init(jax.random.PRNGKey(seed), mem.initialize_carry(B), jnp.zeros((B, d)))["params"]["cell_0"]


def _inputs(family, seed, t, d):
    """``xs [t,B,d]``, ``resets [t,B]`` bool, and the carry (``h`` or ``(c, h)``)."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(t, B, d)).astype(np.float32)
    resets = rng.random((t, B)) < 0.15
    resets[0] = False
    h0 = (0.5 * rng.normal(size=(B, H))).astype(np.float32)
    carry = h0 if family == "gru" else (rng.normal(size=(B, H)).astype(np.float32), h0)
    return xs, resets, carry


def _jnp_tree(tree):
    return tuple(map(jnp.asarray, tree)) if isinstance(tree, tuple) else jnp.asarray(tree)


def _jax_xproj_core(family, cell, carry, xs, resets, dt):
    """The JAX package's xproj path as ``gru_sequence`` / ``_lstm_call`` take
    it for wide inputs or under vmap: one bulk projection, then the core."""
    t, b, _ = xs.shape
    rf = jnp.asarray(resets).astype(jnp.float32).reshape(t, 1, b)
    if family == "gru":
        wi, bi, wh, bhn = pallas_rnn._gru_pack(cell)
        xproj = pallas_rnn._mm(xs.reshape(t * b, -1), wi, dt) + bi
        return pallas_rnn._gru_core(dt, wh, bhn[None, :], carry, xproj.reshape(t, b, -1).astype(jnp.float32), rf)
    wi, wh, bh = pallas_rnn._lstm_pack(cell)
    xproj = pallas_rnn._mm(xs.reshape(t * b, -1), wi, dt)
    hs, _ = pallas_rnn._lstm_core(dt, wh, bh[None, :], carry[0], carry[1],
                                  xproj.reshape(t, b, -1).astype(jnp.float32), rf)
    return hs


def _loss_jax(out):
    return jnp.sum(out * jnp.cos(out))


def _loss_torch(out):
    return torch.sum(out * torch.cos(out))


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got.detach().numpy().astype(np.float64) - want) / (np.linalg.norm(want) + 1e-6)


def _check(got, want, bf16, what, grad=False):
    if bf16 and grad:
        assert _rel_l2(got, want) < BF16_GRAD_REL_L2, f"{what}: relative L2 {_rel_l2(got, want):.3e}"
        return
    rtol, atol = BF16_VALUES if bf16 else ((2e-4, 2e-5) if grad else (1e-5, 1e-5))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _carry_leaves(family, carry, grad=True):
    leaves = [carry] if family == "gru" else list(carry)
    return [torch.tensor(np.asarray(c), requires_grad=grad) for c in leaves]


def _carry_names(family):
    return ("dcarry0",) if family == "gru" else ("dc0", "dh0")


@pytest.mark.parametrize("family", ["gru", "lstm"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_wide_input_replay_matches_pallas(family, bf16):
    """D=520 > 512: the port's one-memory replay takes the xproj replay (G=1)
    as the JAX package's public ``gru_sequence`` / ``lstm_sequence`` take
    ``_gru_core`` / ``_lstm_core``. fp32: values at 1e-5, gradients of the
    packed weights, the carry and xs at rtol 2e-4 / atol 2e-5; bf16 at the
    same-scheme bars."""
    cell = _jax_cell(family, 0, WIDE)
    xs, resets, carry = _inputs(family, 1, T, WIDE)
    dt = jnp.bfloat16 if bf16 else None
    seq = pallas_rnn.gru_sequence if family == "gru" else pallas_rnn.lstm_sequence

    def jax_loss(cell, carry, xs):
        return _loss_jax(seq(cell, carry, xs, jnp.asarray(resets), compute_dtype=dt))

    with pltpu.force_tpu_interpret_mode():
        want = seq(cell, _jnp_tree(carry), jnp.asarray(xs), jnp.asarray(resets), compute_dtype=dt)
        gcell, gcarry, gxs = jax.grad(jax_loss, argnums=(0, 1, 2))(cell, _jnp_tree(carry), jnp.asarray(xs))

    mem = Memory(WIDE, H, family, compute_dtype=torch.bfloat16 if bf16 else None, device="cpu")
    with torch.no_grad():
        for k, v in PACK[family](jax.device_get(cell)).items():
            getattr(mem.cell_0, k).copy_(torch.tensor(v))
    leaves = _carry_leaves(family, carry)
    x = torch.tensor(xs, requires_grad=True)
    got = mem.sequence((leaves[0] if family == "gru" else tuple(leaves),), x, torch.tensor(resets))
    _check(got, want, bf16, "hs")
    _loss_torch(got).backward()
    for k, v in PACK[family](jax.device_get(gcell)).items():
        _check(getattr(mem.cell_0, k).grad, v, bf16, f"d{k}", grad=True)
    gcarry = [gcarry] if family == "gru" else list(gcarry)
    for name, leaf, w in zip(_carry_names(family), leaves, gcarry):
        _check(leaf.grad, w, bf16, name, grad=True)
    _check(x.grad, gxs, bf16, "dxs", grad=True)


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_wide_twins_are_not_paired(family, monkeypatch):
    """``paired_sequence`` pairs only when every layer's input is at most 512
    wide (the JAX pair gate): twins with D=520 run two unpaired xproj
    replays, which equal two ``Memory.sequence`` calls."""

    def refuse(*args, **kwargs):
        raise AssertionError("wide twins were sent to the stream-paired replay")

    monkeypatch.setattr(port_memory, f"{family}_sequence_pair", refuse)
    torch.manual_seed(0)
    mem_a, mem_b = Memory(WIDE, H, family, device="cpu"), Memory(WIDE, H, family, device="cpu")
    xs, resets, carry = _inputs(family, 2, T, WIDE)
    leaves = _carry_leaves(family, carry, grad=False)
    c0 = (leaves[0] if family == "gru" else tuple(leaves),)
    xs, resets = torch.tensor(xs), torch.tensor(resets)
    pa, pb = paired_sequence(mem_a, c0, xs, mem_b, c0, 2 * xs, resets)
    torch.testing.assert_close(pa, mem_a.sequence(c0, xs, resets), rtol=0, atol=0)
    torch.testing.assert_close(pb, mem_b.sequence(c0, 2 * xs, resets), rtol=0, atol=0)


@pytest.mark.parametrize("family", ["gru", "lstm"])
@pytest.mark.parametrize("t,bf16", [(T, False), (1, False), (T, True)], ids=["T6-fp32", "T1-fp32", "T6-bf16"])
def test_seed_axis_replay_matches_pallas_per_seed(family, t, bf16):
    """``*_sequence_xproj`` at G=2 with per-seed weights, carries and resets
    against the JAX xproj core called once per seed: values and the gradients
    of the packed weights (``dwx`` and the input bias through the outside
    projection), the carry and xs."""
    G = 2
    cells = [_jax_cell(family, 10 + g, NARROW) for g in range(G)]
    data = [_inputs(family, 20 + g, t, NARROW) for g in range(G)]
    dt = jnp.bfloat16 if bf16 else None
    wants, jgrads = [], []
    with pltpu.force_tpu_interpret_mode():
        for cell, (xs, resets, carry) in zip(cells, data):
            def jax_loss(cell, carry, xs, resets=resets):
                return _loss_jax(_jax_xproj_core(family, cell, carry, xs, resets, dt))

            wants.append(_jax_xproj_core(family, cell, _jnp_tree(carry), jnp.asarray(xs), resets, dt))
            jgrads.append(jax.grad(jax_loss, argnums=(0, 1, 2))(cell, _jnp_tree(carry), jnp.asarray(xs)))

    packed = [PACK[family](jax.device_get(c)) for c in cells]
    params = {k: torch.tensor(np.stack([p[k] for p in packed]), requires_grad=True) for k in packed[0]}
    carries = [_carry_leaves(family, d[2], grad=False) for d in data]
    leaves = [torch.stack([c[i] for c in carries]).requires_grad_(True) for i in range(len(carries[0]))]
    x = torch.tensor(np.stack([d[0] for d in data]), requires_grad=True)
    resets = torch.tensor(np.stack([d[1] for d in data]))
    if family == "gru":
        got = gru_rnn.gru_sequence_xproj(params, leaves[0], x, resets,
                                         compute_dtype=torch.bfloat16 if bf16 else None)
    else:
        got, _ = lstm_rnn.lstm_sequence_xproj(params, tuple(leaves), x, resets,
                                              compute_dtype=torch.bfloat16 if bf16 else None)
    _loss_torch(got).backward()
    for g in range(G):
        _check(got[g], wants[g], bf16, f"seed {g} hs")
        gcell, gcarry, gxs = jgrads[g]
        for k, v in PACK[family](jax.device_get(gcell)).items():
            _check(params[k].grad[g], v, bf16, f"seed {g} d{k}", grad=True)
        gcarry = [gcarry] if family == "gru" else list(gcarry)
        for name, leaf, w in zip(_carry_names(family), leaves, gcarry):
            _check(leaf.grad[g], w, bf16, f"seed {g} {name}", grad=True)
        _check(x.grad[g], gxs, bf16, f"seed {g} dxs", grad=True)


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_vmapped_paired_replay_equals_per_seed_replays(family):
    """Under ``torch.func.vmap`` over a seed axis, ``paired_sequence`` (which
    the x-streaming replay's vmap rule sends to the xproj replay, seeds x
    streams in one call) equals each seed's own paired replay, values and
    gradients."""
    G = 3
    torch.manual_seed(1)
    mems = [Memory(NARROW, 16, family, device="cpu") for _ in range(2)]
    gen = torch.Generator().manual_seed(2)
    weights = {f"{m}.{k}": torch.randn(G, *v.shape, generator=gen) * 0.3
               for m, mem in zip("ab", mems) for k, v in mem.cell(0).items()}
    xs = torch.randn(G, 5, 4, NARROW, generator=gen)
    resets = torch.rand(G, 5, 4, generator=gen) < 0.3
    carry = torch.randn(G, 4, 16, generator=gen)
    c0 = (carry,) if family == "gru" else ((carry, 0.5 * carry),)

    pair = _Pair(mems)

    def replay(w, x, c, r):
        state = {f"mems.{i}.cell_0.{k}": w[f"{m}.{k}"] for i, m in enumerate("ab") for k in mems[i].cell(0)}
        return torch.func.functional_call(pair, state, (c, x, r))

    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    got = torch.func.vmap(replay)(leaves, xs, c0, resets)
    grads = torch.autograd.grad(sum(_loss_torch(o) for o in got), list(leaves.values()))
    for g in range(G):
        wg = {k: v[g].clone().requires_grad_(True) for k, v in weights.items()}
        want = replay(wg, xs[g], tree_map(lambda t: t[g], c0), resets[g])
        want_grads = torch.autograd.grad(sum(_loss_torch(o) for o in want), list(wg.values()))
        for o, w in zip(got, want):
            torch.testing.assert_close(o[g], w, rtol=1e-5, atol=1e-6)
        for k, a, b in zip(wg, grads, want_grads):
            torch.testing.assert_close(a[g], b, rtol=1e-4, atol=1e-6, msg=k)


class _Pair(torch.nn.Module):
    def __init__(self, mems):
        super().__init__()
        self.mems = torch.nn.ModuleList(mems)

    def forward(self, carry0, xs, resets):
        a, b = self.mems
        return paired_sequence(a, carry0, xs, b, carry0, 2 * xs, resets)


# ------------------------- the plain xproj cores against the Pallas cores

XP_G, XP_B, XP_H = 3, 5, 36
#: the JAX cores tile the batch in blocks of 128 rows (``_pick_block_b``)
JAX_BLOCK_B = 128


def _xp_core_inputs(family, t, seed, XP_G=XP_G, XP_B=XP_B):
    """Numpy inputs of G xproj replays, each stream its own weights, carry and
    reset mask (15% of the rows, and at t=0 the rows b = g mod 3 of stream g)."""
    rng = np.random.default_rng(seed)
    gates = 3 if family == "gru" else 4
    bound = 1.0 / np.sqrt(XP_H)
    f32 = np.float32
    wh = rng.uniform(-bound, bound, (XP_G, XP_H, gates * XP_H)).astype(f32)
    bias = rng.uniform(-bound, bound, (XP_G, XP_H if family == "gru" else 4 * XP_H)).astype(f32)
    carries = [rng.normal(size=(XP_G, XP_B, XP_H)).astype(f32) for _ in range(1 if family == "gru" else 2)]
    xproj = rng.normal(size=(XP_G, t, XP_B, gates * XP_H)).astype(f32)
    resets = rng.random((XP_G, t, XP_B)) < 0.15
    for g in range(XP_G):
        resets[g, 0] = np.arange(XP_B) % 3 == g
    ghs = rng.normal(size=(XP_G, t, XP_B, XP_H)).astype(f32)
    return wh, bias, carries, xproj, resets, ghs


def _pad_rows(a, axis):
    """``a`` with its batch axis padded by zero rows to whole JAX core blocks."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, -a.shape[axis] % JAX_BLOCK_B)
    return np.pad(a, pad)


@pytest.mark.parametrize("family", ["gru", "lstm"])
@pytest.mark.parametrize("t,bf16", [(6, False), (1, False), (6, True), (1, True)],
                         ids=["T6-fp32", "T1-fp32", "T6-bf16", "T1-bf16"])
def test_plain_xproj_cores_match_pallas_per_stream(family, t, bf16):
    """The plain xproj forward, backward and weight-gradient reduction (what
    the xproj kernels are held to on the card) against ``_gru_core`` /
    ``_lstm_core`` in interpret mode, stream by stream: G=3 streams of B=5 rows
    at H=36 with per-stream weights, carries and reset masks. Each stream goes
    to the JAX core padded to its 128-row block with rows whose output
    gradient is zero, so they add nothing to the weight gradients. Values,
    and the gradients of the recurrent weights, the bias, the carry and
    xproj (fp32 and same-scheme bf16 bars)."""
    wh, bias, carries, xproj, resets, ghs = _xp_core_inputs(family, t, seed=40 + t + 2 * bf16)
    dt = jnp.bfloat16 if bf16 else None

    def jax_core(wh, bias, carries, xp, rf, ghs):
        if family == "gru":
            hs, vjp = jax.vjp(lambda w, b, c, x: pallas_rnn._gru_core(dt, w, b, c, x, rf), wh, bias, *carries, xp)
            return hs, vjp(ghs)
        (hs, ct), vjp = jax.vjp(lambda w, b, c, h, x: pallas_rnn._lstm_core(dt, w, b, c, h, x, rf), wh, bias,
                                *carries, xp)
        return hs, vjp((ghs, jnp.zeros_like(ct)))

    wants = []
    with pltpu.force_tpu_interpret_mode():
        core = jax.jit(jax_core)
        for g in range(XP_G):
            rf = jnp.asarray(_pad_rows(resets[g], 1).astype(np.float32)[:, None, :])
            wants.append(core(wh[g], bias[g][None], [_pad_rows(c[g], 0) for c in carries], _pad_rows(xproj[g], 1),
                              rf, _pad_rows(ghs[g], 1)))

    tw = [torch.tensor(a) for a in (wh, bias, *carries, xproj)]
    tr, tg = torch.tensor(resets).float(), torch.tensor(ghs)
    H = XP_H
    if family == "gru":
        hs = gru_rnn.gru_xp_plain_fwd(*tw, tr, bf16)
        dcarry0, gs = gru_rnn.gru_xp_plain_bwd(*tw, tr, hs, tg, bf16)
        dwh, dbias = gru_rnn.gru_xp_plain_wgrad(tr, tw[2], hs, gs, bf16)
        got = (dwh, dbias, dcarry0, gs[..., : 3 * H])
        names = ("dwh", "dbhn", "dcarry0", "dxproj")
    else:
        hs, cs = lstm_rnn.lstm_xp_plain_fwd(*tw, tr, bf16)
        dc0, dh0, gs = lstm_rnn.lstm_xp_plain_bwd(*tw, tr, hs, cs, tg, bf16)
        dwh, dbias = lstm_rnn.lstm_xp_plain_wgrad(tr, tw[3], hs, gs, bf16)
        got = (dwh, dbias, dc0, dh0, gs)
        names = ("dwh", "dbh", "dc0", "dh0", "dxproj")
    for g, (want_hs, want_grads) in enumerate(wants):
        _check(hs[g], np.asarray(want_hs)[:, :XP_B], bf16, f"stream {g} hs")
        for name, a, w in zip(names, got, want_grads):
            w = np.asarray(w)
            if name == "dxproj":
                w = w[:, :XP_B]
            elif name.startswith(("dc", "dh0")):
                w = w[:XP_B]
            elif name.startswith("db"):
                w = w[0]
            _check(a[g], w, bf16, f"stream {g} {name}", grad=True)


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_plain_xproj_forward_matches_pallas_at_kernel_edges(family):
    """The plain xproj forward (what ``gru_xp_fwd`` / ``lstm_xp_fwd`` are held
    to on the card) against ``_gru_core`` / ``_lstm_core`` in interpret mode,
    stream by stream, at the kernels' edge shape: G=17 streams (more than the
    clusters the card runs at once, with no whole number of them a cluster)
    of B=130 rows (past one 128-row tile) at H=36 (no multiple of 4), each
    with its own weights, carry and reset mask; fp32."""
    G, B, t = 17, 130, 2
    wh, bias, carries, xproj, resets, _ = _xp_core_inputs(family, t, seed=90, XP_G=G, XP_B=B)
    if family == "gru":
        core = jax.jit(lambda w, b, c, x, rf: pallas_rnn._gru_core(None, w, b, c[0], x, rf))
    else:
        core = jax.jit(lambda w, b, c, x, rf: pallas_rnn._lstm_core(None, w, b, c[0], c[1], x, rf))
    with pltpu.force_tpu_interpret_mode():
        wants = [core(wh[g], bias[g][None], [_pad_rows(c[g], 0) for c in carries], _pad_rows(xproj[g], 1),
                      jnp.asarray(_pad_rows(resets[g], 1).astype(np.float32)[:, None, :])) for g in range(G)]
    tw = [torch.tensor(a) for a in (wh, bias, *carries, xproj)]
    fwd = gru_rnn.gru_xp_plain_fwd if family == "gru" else lstm_rnn.lstm_xp_plain_fwd
    got = fwd(*tw, torch.tensor(resets).float())
    for g, want in enumerate(wants):
        if family == "gru":
            _check(got[g], np.asarray(want)[:, :B], False, f"stream {g} hs")
        else:
            _check(got[0][g], np.asarray(want[0])[:, :B], False, f"stream {g} hs")
