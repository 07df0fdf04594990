"""The port's GRU and LSTM replay kernels and their plain versions, without JAX, so the
file also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_kernels.py

On the CPU it checks the plain versions (the backward and the weight-gradient
reduction against autograd through the plain forward) and that the kernel
wrappers refuse CPU tensors. The tests marked ``cuda`` hold each CUDA kernel
against its plain version on the card and skip without one.
"""

import math

import pytest
import torch

from rsl_rl_tpu_torch.ops import gru_rnn, lstm_rnn


def _inputs(S, T, B, D, H, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    resets = (torch.rand(T, B, generator=g) < 0.15).float()
    resets[0] = 0.0
    w = (u(S, D, 3 * H), u(S, 3 * H), u(S, H, 3 * H), u(S, H),
         torch.randn(S, B, H, generator=g) * 0.5, torch.randn(S, T, B, D, generator=g), resets)
    ghs = torch.randn(S, T, B, H, generator=g)
    return tuple(t.to(device) for t in w), ghs.to(device)


def _lstm_inputs(S, T, B, D, H, seed, device="cpu"):
    """``(wx, wh, bh, c0, h0, xs, resets)`` and ``ghs`` of an LSTM replay."""
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    resets = (torch.rand(T, B, generator=g) < 0.15).float()
    resets[0] = 0.0
    w = (u(S, D, 4 * H), u(S, H, 4 * H), u(S, 4 * H), torch.randn(S, B, H, generator=g),
         torch.randn(S, B, H, generator=g) * 0.5, torch.randn(S, T, B, D, generator=g), resets)
    ghs = torch.randn(S, T, B, H, generator=g)
    return tuple(t.to(device) for t in w), ghs.to(device)


@pytest.mark.parametrize("S,T", [(1, 5), (2, 5), (2, 1)], ids=["S1T5", "S2T5", "S2T1"])
def test_plain_backward_is_the_gradient_of_plain_forward(S, T):
    """fp32: the plain BPTT chain and weight-gradient reduction equal autograd
    through the plain forward (both sum in another order: rtol 1e-4)."""
    (wx, bx, wh, bhn, carry0, xs, resets), ghs = _inputs(S, T, 16, 6, 8, seed=S * 10 + T)
    leaves = [t.clone().requires_grad_(True) for t in (wx, bx, wh, bhn, carry0, xs)]
    hs = gru_rnn.gru_x_plain_fwd(*leaves, resets)
    want = torch.autograd.grad(hs, leaves, ghs)

    hs = hs.detach()
    dx, dcarry0, gs = gru_rnn.gru_x_plain_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs)
    dwx, dbx, dwh, dbhn = gru_rnn.gru_x_plain_wgrad(xs, resets, carry0, hs, gs)
    for name, got, ref in zip(("dwx", "dbx", "dwh", "dbhn", "dcarry0", "dx"),
                              (dwx, dbx, dwh, dbhn, dcarry0, dx), want):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("S,T", [(1, 5), (2, 5), (2, 1)], ids=["S1T5", "S2T5", "S2T1"])
def test_lstm_plain_backward_is_the_gradient_of_plain_forward(S, T):
    """fp32: the plain LSTM BPTT chain and weight-gradient reduction equal
    autograd through the plain forward, for a loss on ``hs`` and on ``cs``."""
    (wx, wh, bh, c0, h0, xs, resets), ghs = _lstm_inputs(S, T, 16, 6, 8, seed=S * 10 + T + 1)
    leaves = [t.clone().requires_grad_(True) for t in (wx, wh, bh, c0, h0, xs)]
    hs, cs = lstm_rnn.lstm_x_plain_fwd(*leaves, resets)
    want = torch.autograd.grad(hs, leaves, ghs)

    hs, cs = hs.detach(), cs.detach()
    dx, dc0, dh0, gs = lstm_rnn.lstm_x_plain_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs)
    dwx, dwh, dbh = lstm_rnn.lstm_x_plain_wgrad(xs, resets, h0, hs, gs)
    for name, got, ref in zip(("dwx", "dwh", "dbh", "dc0", "dh0", "dx"),
                              (dwx, dwh, dbh, dc0, dh0, dx), want):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("kernel", ["gru_x_fwd", "gru_x_bwd", "gru_x_wgrad"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """No silent fallback: the kernel entry points take CUDA tensors only."""
    w, ghs = _inputs(1, 2, 16, 6, 8, seed=0)
    hs = gru_rnn.gru_x_plain_fwd(*w)
    gs = gru_rnn.gru_x_plain_bwd(*w, hs, ghs)[2]
    args = {
        "gru_x_fwd": w,
        "gru_x_bwd": (*w, hs, ghs),
        "gru_x_wgrad": (w[5], w[6], w[4], hs, gs),
    }[kernel]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        getattr(gru_rnn, kernel)(*args)


@pytest.mark.parametrize("kernel", ["lstm_x_fwd", "lstm_x_bwd", "lstm_x_wgrad"])
def test_lstm_kernel_wrappers_refuse_cpu_tensors(kernel):
    w, ghs = _lstm_inputs(1, 2, 16, 6, 8, seed=0)
    hs, cs = lstm_rnn.lstm_x_plain_fwd(*w)
    gs = lstm_rnn.lstm_x_plain_bwd(*w, hs, cs, ghs)[3]
    args = {
        "lstm_x_fwd": w,
        "lstm_x_bwd": (*w, hs, cs, ghs),
        "lstm_x_wgrad": (w[5], w[6], w[4], hs, gs),
    }[kernel]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        getattr(lstm_rnn, kernel)(*args)


def test_replay_rejects_unknown_compute_dtype():
    w, _ = _inputs(1, 2, 16, 6, 8, seed=1)
    params = dict(zip(("wx", "bx", "wh", "bhn"), (t[0] for t in w[:4])))
    with pytest.raises(ValueError, match="compute_dtype"):
        gru_rnn.gru_sequence_x(params, w[4][0], w[5][0], w[6], compute_dtype=torch.float16)


# --------------------------------------------------------------- on the card

# kernel against plain version; the backward sums over T*B rows in another
# order, so its absolute tolerance is relative to each tensor's max
TOL = {False: (1e-4, 1e-5, 1e-3, 1e-4), True: (1e-3, 2e-3, 1e-2, 5e-3)}


def _close(got, want, rtol, atol_rel, name):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_rel * scale, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,T,bf16", [(2, 24, False), (2, 24, True), (1, 24, False), (2, 1, False)],
    ids=["S2T24-fp32", "S2T24-bf16", "S1T24-fp32", "S2T1-fp32"],
)
def test_kernels_match_plain_on_card(S, T, bf16):
    """Each kernel against its plain version on the same inputs, at the
    main path's widths (D=15, H=256) and a ragged batch of 200 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    w, ghs = _inputs(S, T, 200, 15, 256, seed=S * 100 + T, device="cuda")
    fwd_rtol, fwd_atol, bwd_rtol, bwd_atol_rel = TOL[bf16]
    counts = gru_rnn.launch_counts
    counts.reset()

    hs_plain = gru_rnn.gru_x_plain_fwd(*w, bf16)
    torch.testing.assert_close(gru_rnn.gru_x_fwd(*w, bf16), hs_plain, rtol=fwd_rtol, atol=fwd_atol)
    got = gru_rnn.gru_x_bwd(*w, hs_plain, ghs, bf16)
    want = gru_rnn.gru_x_plain_bwd(*w, hs_plain, ghs, bf16)
    for name, a, b in zip(("dx", "dcarry0", "gscratch"), got, want):
        _close(a, b, bwd_rtol, bwd_atol_rel, name)
    gs = want[2]
    got = gru_rnn.gru_x_wgrad(w[5], w[6], w[4], hs_plain, gs, bf16)
    want = gru_rnn.gru_x_plain_wgrad(w[5], w[6], w[4], hs_plain, gs, bf16)
    for name, a, b in zip(("dwx", "dbx", "dwh", "dbhn"), got, want):
        _close(a, b, bwd_rtol, bwd_atol_rel, name)
    torch.cuda.synchronize()
    assert (counts.fwd_launches, counts.bwd_launches, counts.wgrad_launches) == (1, 1, 1)


@pytest.mark.cuda
def test_replay_autograd_on_card_matches_cpu():
    """``gru_sequence_pair`` on the card (kernels) against the CPU (plain
    version): values and the gradients of every input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    w, ghs = _inputs(2, 8, 64, 15, 256, seed=5)
    results = {}
    for device in ("cpu", "cuda"):
        leaves = [t.to(device).clone().requires_grad_(True) for t in w[:6]]
        params = [dict(zip(("wx", "bx", "wh", "bhn"), (t[s] for t in leaves[:4]))) for s in range(2)]
        hs = gru_rnn.gru_sequence_pair(params, (leaves[4][0], leaves[4][1]),
                                       (leaves[5][0], leaves[5][1]), w[6].to(device))
        out = torch.stack(hs)
        grads = torch.autograd.grad(out, leaves, ghs.to(device))
        results[device] = [out.detach().cpu(), *(g.cpu() for g in grads)]
    for name, a, b in zip(("hs", "dwx", "dbx", "dwh", "dbhn", "dcarry0", "dxs"),
                          results["cuda"], results["cpu"]):
        _close(a, b, 1e-3, 1e-4, name)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "S,T,bf16", [(2, 24, False), (2, 24, True), (1, 24, False), (2, 1, False)],
    ids=["S2T24-fp32", "S2T24-bf16", "S1T24-fp32", "S2T1-fp32"],
)
def test_lstm_kernels_match_plain_on_card(S, T, bf16):
    """Each LSTM kernel against its plain version on the same inputs, at the
    main path's widths (D=15, H=256) and a ragged batch of 200 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    w, ghs = _lstm_inputs(S, T, 200, 15, 256, seed=S * 100 + T + 1, device="cuda")
    fwd_rtol, fwd_atol, bwd_rtol, bwd_atol_rel = TOL[bf16]
    counts = lstm_rnn.launch_counts
    counts.reset()

    hs_plain, cs_plain = lstm_rnn.lstm_x_plain_fwd(*w, bf16)
    hs, cs = lstm_rnn.lstm_x_fwd(*w, bf16)
    torch.testing.assert_close(hs, hs_plain, rtol=fwd_rtol, atol=fwd_atol)
    torch.testing.assert_close(cs, cs_plain, rtol=fwd_rtol, atol=fwd_atol)
    got = lstm_rnn.lstm_x_bwd(*w, hs_plain, cs_plain, ghs, bf16)
    want = lstm_rnn.lstm_x_plain_bwd(*w, hs_plain, cs_plain, ghs, bf16)
    for name, a, b in zip(("dx", "dc0", "dh0", "gscratch"), got, want):
        _close(a, b, bwd_rtol, bwd_atol_rel, name)
    gs = want[3]
    got = lstm_rnn.lstm_x_wgrad(w[5], w[6], w[4], hs_plain, gs, bf16)
    want = lstm_rnn.lstm_x_plain_wgrad(w[5], w[6], w[4], hs_plain, gs, bf16)
    for name, a, b in zip(("dwx", "dwh", "dbh"), got, want):
        _close(a, b, bwd_rtol, bwd_atol_rel, name)
    torch.cuda.synchronize()
    assert (counts.fwd_launches, counts.bwd_launches, counts.wgrad_launches) == (1, 1, 1)


@pytest.mark.cuda
def test_lstm_replay_autograd_on_card_matches_cpu():
    """``lstm_sequence_pair`` on the card (kernels) against the CPU (plain
    version): values and the gradients of every input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    w, ghs = _lstm_inputs(2, 8, 64, 15, 256, seed=6)
    results = {}
    for device in ("cpu", "cuda"):
        leaves = [t.to(device).clone().requires_grad_(True) for t in w[:6]]
        params = [dict(zip(("wx", "wh", "bh"), (t[s] for t in leaves[:3]))) for s in range(2)]
        carries = [(leaves[3][s], leaves[4][s]) for s in range(2)]
        hs = lstm_rnn.lstm_sequence_pair(params, carries, (leaves[5][0], leaves[5][1]), w[6].to(device))
        out = torch.stack(hs)
        grads = torch.autograd.grad(out, leaves, ghs.to(device))
        results[device] = [out.detach().cpu(), *(g.cpu() for g in grads)]
    for name, a, b in zip(("hs", "dwx", "dwh", "dbh", "dc0", "dh0", "dxs"),
                          results["cuda"], results["cpu"]):
        _close(a, b, 1e-3, 1e-4, name)


# ------------------------------------------------------- xproj kernels


def _xp_inputs(family, G, T, B, H, seed, device="cpu"):
    """The xproj kernels' inputs ``(wh, bhn, carry0, xproj, resets)`` (GRU) or
    ``(wh, bh, c0, h0, xproj, resets)`` (LSTM), with one reset mask per
    stream, and an output gradient ``ghs``."""
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)
    gates = 3 if family == "gru" else 4

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    resets = (torch.rand(G, T, B, generator=g) < 0.15).float()
    resets[:, 0] = 0.0
    xproj = torch.randn(G, T, B, gates * H, generator=g)
    if family == "gru":
        w = (u(G, H, 3 * H), u(G, H), torch.randn(G, B, H, generator=g) * 0.5, xproj, resets)
    else:
        w = (u(G, H, 4 * H), u(G, 4 * H), torch.randn(G, B, H, generator=g),
             torch.randn(G, B, H, generator=g) * 0.5, xproj, resets)
    ghs = torch.randn(G, T, B, H, generator=g)
    return tuple(t.to(device) for t in w), ghs.to(device)


XP_KERNELS = {
    "gru": ("gru_xp_fwd", "gru_xp_bwd", "gru_xp_wgrad"),
    "lstm": ("lstm_xp_fwd", "lstm_xp_bwd", "lstm_xp_wgrad"),
}


def _xp_module(family):
    return gru_rnn if family == "gru" else lstm_rnn


def _xp_wgrad_rows(family, w, state, gs):
    """The reduction's inputs: resets, the carry entering step 0, hs, scratch."""
    h0 = w[2] if family == "gru" else w[3]
    return w[-1], h0, state[0], gs


@pytest.mark.parametrize("family", ["gru", "lstm"])
@pytest.mark.parametrize("G,T", [(1, 5), (3, 5), (3, 1)], ids=["G1T5", "G3T5", "G3T1"])
def test_xp_plain_backward_is_the_gradient_of_plain_forward(family, G, T):
    """fp32: the plain xproj BPTT chain and weight-gradient reduction equal
    autograd through the plain xproj forward, per stream with its own resets."""
    mod = _xp_module(family)
    w, ghs = _xp_inputs(family, G, T, 16, 8, seed=G * 10 + T)
    leaves = [t.clone().requires_grad_(True) for t in w[:-1]]
    fwd, bwd, wgrad = (getattr(mod, k.replace("_xp_", "_xp_plain_")) for k in XP_KERNELS[family])
    out = fwd(*leaves, w[-1])
    hs = out if family == "gru" else out[0]
    want = torch.autograd.grad(hs, leaves, ghs)

    state = (hs.detach(),) if family == "gru" else tuple(t.detach() for t in out)
    back = bwd(*w, *state, ghs)
    gs = back[-1]
    H = w[0].shape[-2]
    dxproj = gs[..., : 3 * H] if family == "gru" else gs
    got = (*wgrad(*_xp_wgrad_rows(family, w, state, gs)), *back[:-1], dxproj)
    names = ("dwh", "dbhn", "dcarry0", "dxproj") if family == "gru" else ("dwh", "dbh", "dc0", "dh0", "dxproj")
    for name, a, b in zip(names, got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("kernel", [k for ks in XP_KERNELS.values() for k in ks])
def test_xp_kernel_wrappers_refuse_cpu_tensors(kernel):
    """No silent fallback for the xproj kernels either."""
    family = kernel.split("_")[0]
    mod = _xp_module(family)
    w, ghs = _xp_inputs(family, 2, 2, 16, 8, seed=0)
    out = getattr(mod, f"{family}_xp_plain_fwd")(*w)
    state = (out,) if family == "gru" else out
    gs = getattr(mod, f"{family}_xp_plain_bwd")(*w, *state, ghs)[-1]
    args = {"fwd": w, "bwd": (*w, *state, ghs), "wgrad": _xp_wgrad_rows(family, w, state, gs)}
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        getattr(mod, kernel)(*args[kernel.split("_")[-1]])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gru", "lstm"])
@pytest.mark.parametrize(
    "G,T,B,bf16", [(16, 24, 128, False), (16, 24, 128, True), (1, 24, 200, False), (3, 1, 128, False)],
    ids=["G16T24-fp32", "G16T24-bf16", "G1T24B200-fp32", "G3T1-fp32"],
)
def test_xp_kernels_match_plain_on_card(family, G, T, B, bf16):
    """Each xproj kernel against its plain version on the same inputs (H=256,
    per-stream resets), at the multi-seed main path's shape and a ragged
    batch of 200 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = _xp_module(family)
    fwd, bwd, wgrad = XP_KERNELS[family]
    w, ghs = _xp_inputs(family, G, T, B, 256, seed=G * 100 + T, device="cuda")
    fwd_rtol, fwd_atol, bwd_rtol, bwd_atol_rel = TOL[bf16]
    counts = mod.xp_launch_counts
    counts.reset()

    def plain(name):
        return getattr(mod, name.replace("_xp_", "_xp_plain_"))

    want = plain(fwd)(*w, bf16)
    got = getattr(mod, fwd)(*w, bf16)
    state = (want,) if family == "gru" else want
    for a, b in zip((got,) if family == "gru" else got, state):
        torch.testing.assert_close(a, b, rtol=fwd_rtol, atol=fwd_atol)
    got = getattr(mod, bwd)(*w, *state, ghs, bf16)
    want = plain(bwd)(*w, *state, ghs, bf16)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, bwd_rtol, bwd_atol_rel, f"{bwd} output {i}")
    rows = _xp_wgrad_rows(family, w, state, want[-1])
    for i, (a, b) in enumerate(zip(getattr(mod, wgrad)(*rows, bf16), plain(wgrad)(*rows, bf16))):
        _close(a, b, bwd_rtol, bwd_atol_rel, f"{wgrad} output {i}")
    torch.cuda.synchronize()
    assert (counts.fwd_launches, counts.bwd_launches, counts.wgrad_launches) == (1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_xp_replay_autograd_on_card_matches_cpu(family):
    """The seed-axis replay (``*_sequence_xproj``, G=3, per-stream resets, a
    wide input D=520) on the card against the CPU: values and the gradients
    of every input, through the outside projection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    G, T, B, D, H = 3, 8, 64, 520, 256
    gen = torch.Generator().manual_seed(7)
    gates = 3 if family == "gru" else 4
    names = ("wx", "bx", "wh", "bhn") if family == "gru" else ("wx", "wh", "bh")
    shapes = {"wx": (G, D, gates * H), "bx": (G, gates * H), "wh": (G, H, gates * H), "bhn": (G, H),
              "bh": (G, gates * H)}
    weights = [(torch.rand(shapes[k], generator=gen) * 2 - 1) / math.sqrt(H) for k in names]
    carries = [torch.randn(G, B, H, generator=gen) for _ in range(1 if family == "gru" else 2)]
    xs = torch.randn(G, T, B, D, generator=gen)
    resets = (torch.rand(G, T, B, generator=gen) < 0.15).float()
    ghs = torch.randn(G, T, B, H, generator=gen)
    results = {}
    for device in ("cpu", "cuda"):
        leaves = [t.to(device).clone().requires_grad_(True) for t in (*weights, *carries, xs)]
        params = dict(zip(names, leaves[: len(names)]))
        carry0 = leaves[len(names)] if family == "gru" else tuple(leaves[len(names) : len(names) + 2])
        seq = gru_rnn.gru_sequence_xproj if family == "gru" else lstm_rnn.lstm_sequence_xproj
        out = seq(params, carry0, leaves[-1], resets.to(device))
        hs = out if family == "gru" else out[0]
        grads = torch.autograd.grad(hs, leaves, ghs.to(device))
        results[device] = [hs.detach().cpu(), *(g.cpu() for g in grads)]
    for i, (a, b) in enumerate(zip(results["cuda"], results["cpu"])):
        _close(a, b, 1e-3, 1e-4, f"output {i}")


# ------------------------------------------- the weight-gradient plan (CPU)

from rsl_rl_tpu_torch.ops.rnn_common import WGRAD_BLOCKS_PER_SM, wgrad_plan  # noqa: E402

H100_SMS = 132


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "S,T,B,D",
    [(2, 24, 1024, 15), (16, 24, 128, 0), (1, 24, 1024, 15), (1, 24, 1024, 0)],
    ids=["x-S2", "xp-G16", "x-S1", "xp-G1"],
)
def test_wgrad_plan_fills_one_wave(S, T, B, D, bf16):
    """At every main-path shape the reduction's blocks fill at least 90% of
    one wave on the 132 SMs of an H100 and no more than one, and every split
    has rows."""
    plan = wgrad_plan(S, T, B, D, 256, H100_SMS, bf16)
    blocks = S * plan.row_tiles * plan.col_tiles * plan.splits
    assert 0.9 * H100_SMS * WGRAD_BLOCKS_PER_SM[bf16] <= blocks <= WGRAD_BLOCKS_PER_SM[bf16] * H100_SMS
    assert plan.splits * 32 <= T * B


@pytest.mark.parametrize(
    "bf16,H,D,row_tiles,tail",
    [(False, 256, 15, 2, 15), (False, 256, 0, 2, 0), (False, 200, 15, 2, 0), (False, 130, 0, 1, 2),
     (False, 8, 6, 1, 0), (False, 256, 48, 3, 0), (True, 256, 15, 1, 15), (True, 256, 0, 1, 0),
     (True, 200, 15, 1, 0), (True, 256, 272, 2, 16)],
)
def test_wgrad_plan_row_tiles(bf16, H, D, row_tiles, tail):
    """The row tiles (128 operand rows in fp32 mode, 256 in bf16) cover the
    H+D operand rows; up to 16 rows beyond the full tiles ride on the first
    row tile instead of a tile of their own."""
    plan = wgrad_plan(1, 24, 1024, D, H, H100_SMS, bf16)
    assert (plan.row_tiles, plan.tail) == (row_tiles, tail)
    assert plan.row_tiles * (256 if bf16 else 128) + plan.tail >= H + D
    assert plan.col_tiles == -(-4 * H // 128)


def test_wgrad_plan_keeps_small_windows_whole():
    """A short window is not cut into splits of a few rows."""
    assert wgrad_plan(2, 1, 200, 15, 256, H100_SMS).splits == 1
    assert wgrad_plan(1, 24, 1024, 15, 256, 8).splits == 1
    assert wgrad_plan(1, 24, 1024, 15, 256, 4, bf16=True).splits == 1


@pytest.mark.parametrize("D", [6, 0], ids=["x", "xp"])
def test_gru_wgrad_outputs_read_no_dropped_block(D):
    """The GRU gradients come from the reduction's C without reading a block
    the kernel leaves out (filled with NaN here), and equal the plain ones."""
    S, T, B, H = 2, 3, 16, 8
    (wx, bx, wh, bhn, carry0, xs, resets), ghs = _inputs(S, T, B, max(D, 1), H, seed=3)
    xs = xs[..., :D]
    wx = wx[:, :D]
    hs = gru_rnn.gru_x_plain_fwd(wx, bx, wh, bhn, carry0, xs, resets)
    gs = gru_rnn.gru_x_plain_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs)[2]
    h_prev = torch.cat([carry0[:, None], hs[:, :-1]], dim=1) * (1.0 - resets)[None, ..., None]
    A = torch.cat([h_prev, xs, torch.ones(S, T, B, 1)], dim=-1).reshape(S, T * B, -1)
    C = A.transpose(1, 2) @ gs.reshape(S, T * B, 4 * H)
    for rows, cols in gru_rnn.gru_wgrad_dropped(H, D):
        C[:, rows, cols] = float("nan")
    got = gru_rnn.gru_wgrad_outputs(C, H, D)
    want = gru_rnn.gru_x_plain_wgrad(xs, resets, carry0, hs, gs)
    for name, a, b in zip(("dwx", "dbx", "dwh", "dbhn"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,T", [(1, 1), (1, 5), (2, 1), (2, 5)], ids=["S1T1", "S1T5", "S2T1", "S2T5"])
def test_lstm_phased_plain_backward_is_autograd(S, T, bf16):
    """The plain LSTM backward, in the kernel's phases (all gates at once, the
    chain, dx at once), equals autograd through the plain forward: fp32 to
    summation order; in bf16 mode within the bf16 bars, since the chain rounds
    the gate gradients it multiplies, where autograd does not."""
    (wx, wh, bh, c0, h0, xs, resets), ghs = _lstm_inputs(S, T, 16, 6, 8, seed=S * 10 + T + 7)
    resets[0, :4] = 1.0  # resets at t=0 too
    leaves = [t.clone().requires_grad_(True) for t in (wx, wh, bh, c0, h0, xs)]
    hs, cs = lstm_rnn.lstm_x_plain_fwd(*leaves, resets, bf16)
    want = torch.autograd.grad(hs, leaves, ghs)
    hs, cs = hs.detach(), cs.detach()
    dx, dc0, dh0, gs = lstm_rnn.lstm_x_plain_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, bf16)
    dwx, dwh, dbh = lstm_rnn.lstm_x_plain_wgrad(xs, resets, h0, hs, gs, bf16)
    for name, got, ref in zip(("dwx", "dwh", "dbh", "dc0", "dh0", "dx"), (dwx, dwh, dbh, dc0, dh0, dx), want):
        if bf16:
            _close(got, ref, TOL[True][2], TOL[True][3], name)
        else:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,T", [(1, 1), (1, 5), (2, 1), (2, 5)], ids=["S1T1", "S1T5", "S2T1", "S2T5"])
def test_gru_phased_plain_backward_is_autograd(S, T, bf16):
    """The plain GRU backward, in the kernel's phases (all gates at once, the
    chain, dx at once), equals autograd through the plain forward: fp32 to
    summation order; in bf16 mode within the bf16 bars, since the chain rounds
    the gate gradients it multiplies, where autograd does not."""
    (wx, bx, wh, bhn, carry0, xs, resets), ghs = _inputs(S, T, 16, 6, 8, seed=S * 10 + T + 9)
    resets[0, :4] = 1.0  # resets at t=0 too
    leaves = [t.clone().requires_grad_(True) for t in (wx, bx, wh, bhn, carry0, xs)]
    hs = gru_rnn.gru_x_plain_fwd(*leaves, resets, bf16)
    want = torch.autograd.grad(hs, leaves, ghs)
    hs = hs.detach()
    dx, dcarry0, gs = gru_rnn.gru_x_plain_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, bf16)
    dwx, dbx, dwh, dbhn = gru_rnn.gru_x_plain_wgrad(xs, resets, carry0, hs, gs, bf16)
    for name, got, ref in zip(("dwx", "dbx", "dwh", "dbhn", "dcarry0", "dx"),
                              (dwx, dbx, dwh, dbhn, dcarry0, dx), want):
        if bf16:
            _close(got, ref, TOL[True][2], TOL[True][3], name)
        else:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6, msg=name)


#: every kernel entry point: (name, cell, kernel set)
ENTRY_POINTS = [(f"{cell}_{kind}_{part}", cell, kind)
                for cell in ("gru", "lstm") for kind in ("x", "xp") for part in ("fwd", "bwd", "wgrad")]


def _wrapper_args(name, cell, kind, H):
    """Zero CPU inputs of hidden width H for a kernel wrapper (S=1, T=1, B=2, D=3)."""
    S, T, B, D = 1, 1, 2, 3
    gates = 3 if cell == "gru" else 4
    z = torch.zeros
    carries = (z(S, B, H),) if cell == "gru" else (z(S, B, H), z(S, B, H))
    state = (z(S, T, B, H),) if cell == "gru" else (z(S, T, B, H), z(S, T, B, H))
    gs = z(S, T, B, 4 * H)
    if kind == "x":
        weights = (z(S, D, 3 * H), z(S, 3 * H), z(S, H, 3 * H), z(S, H)) if cell == "gru" else (
            z(S, D, 4 * H), z(S, H, 4 * H), z(S, 4 * H))
        w = (*weights, *carries, z(S, T, B, D), z(T, B))
        rows = (w[-2], w[-1], carries[-1], state[0], gs)
    else:
        weights = (z(S, H, 3 * H), z(S, H)) if cell == "gru" else (z(S, H, 4 * H), z(S, 4 * H))
        w = (*weights, *carries, z(S, T, B, gates * H), z(S, T, B))
        rows = (w[-1], carries[-1], state[0], gs)
    part = name.rsplit("_", 1)[1]
    return {"fwd": w, "bwd": (*w, *state, z(S, T, B, H)), "wgrad": rows}[part]


@pytest.mark.parametrize("name,cell,kind", ENTRY_POINTS, ids=[e[0] for e in ENTRY_POINTS])
def test_kernel_wrappers_take_hidden_up_to_512(name, cell, kind):
    """Every entry point's checks take H=512, the widest the JAX package's
    single-stream kernels take (here they go on to refuse the CPU tensors),
    and refuse H=513: there is no fallback above it."""
    fn = getattr(gru_rnn if cell == "gru" else lstm_rnn, name)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fn(*_wrapper_args(name, cell, kind, 512))
    with pytest.raises(ValueError, match="H <= 512, got H=513"):
        fn(*_wrapper_args(name, cell, kind, 513))


# -------------------- the redesigned kernels on the card: edges, repeatability

#: (family, streams, T, B, D, H): H that the 128- and 64-wide tiles do not
#: divide (and, at H=200, 25 hidden columns a CTA of lstm_x_fwd's clusters), a
#: ragged batch (203 rows: no whole number of a cluster's rows), one-step
#: windows, per-stream resets for the xproj families, and the hidden states
#: above 256 (two columns a thread in the one-thread-per-column kernels, the
#: weights streamed from L2 in lstm_x_fwd)
EDGE_CASES = [
    ("lstm", 2, 5, 200, 15, 200),
    ("lstm", 1, 1, 200, 15, 128),
    ("gru", 2, 5, 200, 15, 200),
    ("gru", 1, 1, 200, 15, 128),
    ("gru_xp", 3, 5, 200, 0, 200),
    ("lstm_xp", 3, 5, 200, 0, 128),
    ("lstm", 1, 5, 203, 15, 200),
    ("gru", 1, 5, 203, 15, 200),
    ("lstm", 2, 3, 64, 15, 384),
    ("lstm", 1, 2, 48, 15, 512),
    ("gru", 2, 3, 64, 15, 384),
    ("gru", 1, 2, 48, 15, 512),
    ("gru_xp", 2, 3, 64, 0, 384),
    ("gru_xp", 1, 2, 48, 0, 512),
    ("lstm_xp", 2, 3, 64, 0, 384),
    ("lstm_xp", 1, 2, 48, 0, 512),
]


def _edge_case(family, S, T, B, D, H, seed):
    """Inputs on the card with resets at t=0 and mid-window; the plain
    backward's outputs; the kernels' and plain versions' calls."""
    cell = family.split("_")[0]
    if family.endswith("_xp"):
        w, ghs = _xp_inputs(cell, S, T, B, H, seed, device="cuda")
        w[-1][:, 0, : B // 3] = 1.0
    else:
        w, ghs = (_inputs if cell == "gru" else _lstm_inputs)(S, T, B, D, H, seed, device="cuda")
        w[-1][0, : B // 3] = 1.0
    return cell, w, ghs


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("family,S,T,B,D,H", EDGE_CASES,
                         ids=[f"{c[0]}-S{c[1]}T{c[2]}B{c[3]}H{c[5]}" for c in EDGE_CASES])
def test_redesigned_kernels_edge_shapes_on_card(family, S, T, B, D, H, bf16):
    """The family's three kernels (the redesigned ``lstm_x_fwd``,
    ``gru_x_bwd``, ``lstm_x_bwd`` and weight-gradient reductions among them)
    against their plain versions at edge shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell, w, ghs = _edge_case(family, S, T, B, D, H, seed=S * 1000 + T * 10 + H)
    fwd_rtol, fwd_atol, bwd_rtol, bwd_atol_rel = TOL[bf16]
    mod = gru_rnn if cell == "gru" else lstm_rnn
    kind = "xp" if family.endswith("_xp") else "x"
    fwd, bwd, wgrad = (getattr(mod, f"{cell}_{kind}_{p}") for p in ("fwd", "bwd", "wgrad"))
    plain_fwd, plain_bwd, plain_wgrad = (getattr(mod, f"{cell}_{kind}_plain_{p}") for p in ("fwd", "bwd", "wgrad"))
    out = plain_fwd(*w, bf16)
    state = (out,) if cell == "gru" else out
    got = fwd(*w, bf16)
    for part, a, b in zip(("hs", "cs"), (got,) if cell == "gru" else got, state):
        torch.testing.assert_close(a, b, rtol=fwd_rtol, atol=fwd_atol, msg=f"{family} fwd {part}")
    want = plain_bwd(*w, *state, ghs, bf16)
    for i, (a, b) in enumerate(zip(bwd(*w, *state, ghs, bf16), want)):
        _close(a, b, bwd_rtol, bwd_atol_rel, f"{family} bwd output {i}")
    if kind == "xp":
        rows = _xp_wgrad_rows(cell, w, state, want[-1])
    else:
        rows = (w[5], w[6], w[4], state[0], want[-1])  # w[4]: the GRU's carry0, the LSTM's h0
    for i, (a, b) in enumerate(zip(wgrad(*rows, bf16), plain_wgrad(*rows, bf16))):
        _close(a, b, bwd_rtol, bwd_atol_rel, f"{family} wgrad output {i}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_redesigned_kernels_are_bitwise_repeatable_on_card(bf16):
    """Two calls give the same bits: the outputs of the cluster forwards
    ``gru_x_fwd``, ``lstm_x_fwd``, ``gru_xp_fwd`` and ``lstm_xp_fwd``, of the three-phase
    backwards ``gru_x_bwd``, ``lstm_x_bwd``, ``gru_xp_bwd`` and
    ``lstm_xp_bwd``, and of every weight-gradient reduction, at the main
    paths' shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    calls = {}
    w, ghs = _lstm_inputs(2, 24, 1024, 15, 256, seed=21, device="cuda")
    hs, cs = lstm_rnn.lstm_x_plain_fwd(*w, bf16)
    calls["lstm_x_fwd"] = lambda: lstm_rnn.lstm_x_fwd(*w, bf16)
    calls["lstm_x_bwd"] = lambda: lstm_rnn.lstm_x_bwd(*w, hs, cs, ghs, bf16)
    gs = lstm_rnn.lstm_x_plain_bwd(*w, hs, cs, ghs, bf16)[-1]
    calls["lstm_x_wgrad"] = lambda: lstm_rnn.lstm_x_wgrad(w[5], w[6], w[4], hs, gs, bf16)
    gw, gghs = _inputs(2, 24, 1024, 15, 256, seed=22, device="cuda")
    ghs_ = gru_rnn.gru_x_plain_fwd(*gw, bf16)
    calls["gru_x_fwd"] = lambda: (gru_rnn.gru_x_fwd(*gw, bf16),)
    calls["gru_x_bwd"] = lambda: gru_rnn.gru_x_bwd(*gw, ghs_, gghs, bf16)
    ggs = gru_rnn.gru_x_plain_bwd(*gw, ghs_, gghs, bf16)[-1]
    calls["gru_x_wgrad"] = lambda: gru_rnn.gru_x_wgrad(gw[5], gw[6], gw[4], ghs_, ggs, bf16)
    for cell in ("gru", "lstm"):
        xw, xghs = _xp_inputs(cell, 16, 24, 128, 256, seed=23, device="cuda")
        mod = _xp_module(cell)
        out = getattr(mod, f"{cell}_xp_plain_fwd")(*xw, bf16)
        state = (out,) if cell == "gru" else out
        xgs = getattr(mod, f"{cell}_xp_plain_bwd")(*xw, *state, xghs, bf16)[-1]
        rows = _xp_wgrad_rows(cell, xw, state, xgs)
        calls[f"{cell}_xp_bwd"] = (lambda mod=mod, cell=cell, xw=xw, state=state, xghs=xghs:
                                   getattr(mod, f"{cell}_xp_bwd")(*xw, *state, xghs, bf16))
        calls[f"{cell}_xp_wgrad"] = lambda mod=mod, cell=cell, rows=rows: getattr(mod, f"{cell}_xp_wgrad")(*rows, bf16)
        if cell == "lstm":
            calls["lstm_xp_fwd"] = lambda xw=xw: lstm_rnn.lstm_xp_fwd(*xw, bf16)
        else:
            calls["gru_xp_fwd"] = lambda xw=xw: (gru_rnn.gru_xp_fwd(*xw, bf16),)
    for name, call in calls.items():
        first = [t.clone() for t in call()]
        second = call()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(first, second)):
            assert torch.equal(a, b), f"{name} output {i} differs between two calls"


# -------------------------------- gru_x_fwd (cluster forward) and lstm_xp_bwd

#: (S, H, B, T) of the GRU cluster forward: both stream counts, hidden sizes
#: that fill a CTA's 32-column tiles or not (H=200: 25 hidden columns a CTA)
#: and whose weight slices stay in shared memory or stream from L2 (384, 512),
#: batches below, across and at the main path's rows (48, 203, 1024), and
#: windows of 1, 5 and 24 steps
GRU_FWD_CASES = [(S, H, B, T) for S in (1, 2) for H in (128, 200, 256, 384, 512) for B in (48, 203, 1024)
                 for T in (1, 5, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,H,B,T", GRU_FWD_CASES, ids=[f"S{c[0]}H{c[1]}B{c[2]}T{c[3]}" for c in GRU_FWD_CASES])
def test_gru_x_fwd_shapes_on_card(S, H, B, T, bf16):
    """``gru_x_fwd`` against its plain version (D=15, a third of the rows reset
    at t=0 and 15% of them later)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    w, _ = _inputs(S, T, B, 15, H, seed=S * 100000 + H * 100 + T, device="cuda")
    w[-1][0, : B // 3] = 1.0
    fwd_rtol, fwd_atol = TOL[bf16][:2]
    torch.testing.assert_close(gru_rnn.gru_x_fwd(*w, bf16), gru_rnn.gru_x_plain_fwd(*w, bf16),
                               rtol=fwd_rtol, atol=fwd_atol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("G,T,B", [(1, 24, 203), (2, 5, 128), (16, 24, 128)], ids=["G1", "G2", "G16"])
def test_lstm_xp_bwd_per_stream_resets_on_card(G, T, B, bf16):
    """``lstm_xp_bwd`` against its plain version where every stream has its
    own reset mask: stream g also resets the rows b = g (mod 3) at t=0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    w, ghs = _xp_inputs("lstm", G, T, B, 256, seed=G * 10 + T, device="cuda")
    for g in range(G):
        w[-1][g, 0, g % 3 :: 3] = 1.0
    bwd_rtol, bwd_atol_rel = TOL[bf16][2:]
    hs, cs = lstm_rnn.lstm_xp_plain_fwd(*w, bf16)
    got = lstm_rnn.lstm_xp_bwd(*w, hs, cs, ghs, bf16)
    want = lstm_rnn.lstm_xp_plain_bwd(*w, hs, cs, ghs, bf16)
    for name, a, b in zip(("dc0", "dh0", "gscratch"), got, want):
        _close(a, b, bwd_rtol, bwd_atol_rel, name)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["gru_x_bwd_phase_ms", "lstm_x_bwd_phase_ms", "gru_xp_bwd_phase_ms",
                                  "lstm_xp_bwd_phase_ms"])
def test_phase_timing_wrappers_refuse_cpu_tensors(name):
    """The backwards' phase-timing calls launch the kernels too: CUDA tensors only."""
    cell, kind = name.split("_")[:2]
    fn = getattr(gru_rnn if cell == "gru" else lstm_rnn, name)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fn(*_wrapper_args(f"{cell}_{kind}_bwd", cell, kind, 8))


# ------------- gru_xp_bwd (three phases) and lstm_xp_fwd (cluster forward)

#: (G, B, H) of the redesigned xproj kernels: one stream, three, the
#: multi-seed path's 16 and one more than that; batches of 1, 7, 128 and 130
#: rows; hidden sizes from 1 to 512 (36: no multiple of 4 nor of a CTA's
#: 32-column tiles; 384 and 512: the forward's weight slices stream from L2)
XP_REDESIGNED_CASES = [(G, B, H) for G in (1, 3, 16, 17) for B in (1, 7, 128, 130) for H in (1, 36, 256, 384, 512)]


def _xp_per_stream_resets(cell, G, T, B, H, seed):
    """xproj inputs on the card where every stream has its own weights and
    reset mask: 15% of the rows, and at t=0 the rows b = g (mod 3) of stream g."""
    w, ghs = _xp_inputs(cell, G, T, B, H, seed, device="cuda")
    for g in range(G):
        w[-1][g, 0, g % 3 :: 3] = 1.0
    return w, ghs


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 24], ids=["T1", "T24"])
@pytest.mark.parametrize("G,B,H", XP_REDESIGNED_CASES, ids=[f"G{c[0]}B{c[1]}H{c[2]}" for c in XP_REDESIGNED_CASES])
def test_redesigned_xp_kernels_on_card(G, B, H, T, bf16):
    """``lstm_xp_fwd``, ``gru_xp_fwd`` and ``gru_xp_bwd`` against their plain
    versions at the phase-3 bars of ``chip_smoke.py``, per-stream weights and
    resets; two calls of each give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    fwd_rtol, fwd_atol, bwd_rtol, bwd_atol_rel = TOL[bf16]
    w, _ = _xp_per_stream_resets("lstm", G, T, B, H, seed=G * 1000 + B * 10 + H + T)
    want = lstm_rnn.lstm_xp_plain_fwd(*w, bf16)
    got = [t.clone() for t in lstm_rnn.lstm_xp_fwd(*w, bf16)]
    for part, a, b in zip(("hs", "cs"), got, want):
        torch.testing.assert_close(a, b, rtol=fwd_rtol, atol=fwd_atol, msg=f"lstm_xp_fwd {part}")
    assert all(torch.equal(a, b) for a, b in zip(got, lstm_rnn.lstm_xp_fwd(*w, bf16))), "lstm_xp_fwd not repeatable"

    w, ghs = _xp_per_stream_resets("gru", G, T, B, H, seed=G * 1000 + B * 10 + H + T + 1)
    hs = gru_rnn.gru_xp_plain_fwd(*w, bf16)
    got = gru_rnn.gru_xp_fwd(*w, bf16).clone()
    torch.testing.assert_close(got, hs, rtol=fwd_rtol, atol=fwd_atol, msg="gru_xp_fwd hs")
    assert torch.equal(got, gru_rnn.gru_xp_fwd(*w, bf16)), "gru_xp_fwd not repeatable"
    want = gru_rnn.gru_xp_plain_bwd(*w, hs, ghs, bf16)
    got = [t.clone() for t in gru_rnn.gru_xp_bwd(*w, hs, ghs, bf16)]
    for part, a, b in zip(("dcarry0", "gscratch"), got, want):
        _close(a, b, bwd_rtol, bwd_atol_rel, f"gru_xp_bwd {part}")
    assert all(torch.equal(a, b) for a, b in zip(got, gru_rnn.gru_xp_bwd(*w, hs, ghs, bf16))), "gru_xp_bwd not repeatable"
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,H,waves", [(40, 16, 64, "one"), (40, 16, 384, "several"), (16, 128, 256, "one"),
                                         (24, 64, 384, "several"), (17, 130, 256, "any"), (17, 130, 36, "any")],
                         ids=["G40-plan", "G40H384-waves", "G16-plan", "G24H384-waves", "G17-plan", "G17H36-plan"])
def test_lstm_xp_fwd_layouts_on_card(G, B, H, waves):
    """``lstm_xp_fwd``'s cluster forward (bf16 mode) where the streams
    outnumber the clusters the card runs at once: in one wave, each cluster
    serving whole streams and a share of the rest, and above H=256, where the
    weight slices are streamed from L2 and each stream takes a cluster of its
    own, in more waves than the card runs (clusters never wait for each
    other, so the result must not depend on the waves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = lstm_rnn.lstm_xp_fwd_plan(G, B, H, True)
    if waves == "one":
        assert G > plan["active_clusters"] and plan["parts"] > 1 and plan["waves"] == 1, plan
    elif waves == "several":
        assert not plan["resident"] and plan["parts"] == 1 and plan["waves"] > 1, plan
    fwd_rtol, fwd_atol = TOL[True][:2]
    w, _ = _xp_per_stream_resets("lstm", G, 24, B, H, seed=G + B + H)
    for part, a, b in zip(("hs", "cs"), lstm_rnn.lstm_xp_fwd(*w, True),
                          lstm_rnn.lstm_xp_plain_fwd(*w, True)):
        torch.testing.assert_close(a, b, rtol=fwd_rtol, atol=fwd_atol, msg=part)
    torch.cuda.synchronize()


# ------------------- gru_xp_fwd (cluster forward) and lstm_xp_fwd in fp32 mode

#: (G, B, H, layout, fp32 kernel) of the xproj forwards where the streams
#: outnumber the clusters the card runs at once, and at G=1, with the layout
#: the cluster forward takes: "share" the multi-seed path's 16 streams in one
#: wave (a cluster serves a whole stream and a share of the sixteenth's rows,
#: holding both weight slices), "one" one wave where a cluster holds several
#: streams' slices (G=40 at H=64), "several" a cluster a stream in several
#: waves (two slices do not fit: the GRU's bf16 ones at H=288; G=40 at
#: H=384), "any" G=17 at a ragged batch, "single" one stream of the
#: wide-input path over the clusters in one wave (fp32: one 80-row tile of 69
#: rows a cluster); and the kernel fp32 mode takes there ("columns": one
#: thread a column, at G=16 and where the weight slices would stream from
#: L2; "any" where the step costs of the two lie close or were not timed)
XP_LAYOUT_CASES = [(16, 128, 256, "share", "columns"), (16, 64, 288, "several", "columns"),
                   (17, 130, 256, "any", "any"), (17, 130, 36, "any", "any"), (40, 16, 64, "one", "any"),
                   (40, 16, 384, "several", "columns"), (1, 1024, 256, "single", "cluster")]
XP_LAYOUT_IDS = [f"G{g}B{b}H{h}" for g, b, h, _, _ in XP_LAYOUT_CASES]


def _check_xp_fwd_layout(cell, G, B, H, layout, fp32_kernel, bf16):
    """The xproj forward of ``cell`` against its plain version at the phase-3
    bars, per-stream resets, and the plan's keys for the layout."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = _xp_module(cell)
    plan = getattr(mod, f"{cell}_xp_fwd_plan")(G, B, H, bf16)
    assert plan["kernel"] == ("cluster" if bf16 else fp32_kernel) or (not bf16 and fp32_kernel == "any"), plan
    if plan["kernel"] == "columns":
        pass  # no grid to check
    elif layout == "share":
        assert G > plan["active_clusters"] and plan["parts"] == 2 and plan["waves"] == 1, plan
    elif layout == "one":
        assert G > plan["active_clusters"] and plan["parts"] > 1 and plan["waves"] == 1, plan
    elif layout == "several":
        assert plan["parts"] == 1 and plan["waves"] > 1, plan
    elif layout == "single":
        assert plan["kernel"] == "cluster" and plan["clusters"] == plan["active_clusters"], plan
        assert plan["waves"] == 1 and plan["parts"] == 1, plan
        assert plan["tail_rows"] == (80 if not bf16 else 96 if cell == "gru" else 128), plan
    fwd_rtol, fwd_atol = TOL[bf16][:2]
    w, _ = _xp_per_stream_resets(cell, G, 24, B, H, seed=G + B + H + bf16)
    got = getattr(mod, f"{cell}_xp_fwd")(*w, bf16)
    want = getattr(mod, f"{cell}_xp_plain_fwd")(*w, bf16)
    for part, a, b in zip(("hs", "cs"), (got,) if cell == "gru" else got, (want,) if cell == "gru" else want):
        torch.testing.assert_close(a, b, rtol=fwd_rtol, atol=fwd_atol, msg=f"{cell}_xp_fwd {part}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("G,B,H,layout,fp32_kernel", XP_LAYOUT_CASES, ids=XP_LAYOUT_IDS)
def test_gru_xp_fwd_layouts_on_card(G, B, H, layout, fp32_kernel, bf16):
    """``gru_xp_fwd`` in both modes at the layouts of ``XP_LAYOUT_CASES``:
    in bf16 mode the cluster forward, G=16 in one wave with a whole stream
    and a share of the sixteenth a cluster, more streams in one or several
    waves; in fp32 mode the case's kernel; and one stream of 1024 rows on the
    cluster forward in both modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _check_xp_fwd_layout("gru", G, B, H, layout, fp32_kernel, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,H,layout,fp32_kernel", XP_LAYOUT_CASES, ids=XP_LAYOUT_IDS)
def test_lstm_xp_fwd_fp32_layouts_on_card(G, B, H, layout, fp32_kernel):
    """``lstm_xp_fwd``'s fp32 mode at the shapes of
    :func:`test_gru_xp_fwd_layouts_on_card`, on the case's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _check_xp_fwd_layout("lstm", G, B, H, layout, fp32_kernel, False)


#: (cell, G, B, kernel) where the kernel_ab.py sweep of fp32 mode at H=256
#: timed one kernel faster than the other by 10% or more on an H100, and the
#: plan's step costs agree: the kernel the plan must take
XP_FP32_WINNERS = [("gru", 1, 1024, "cluster"), ("gru", 4, 1024, "columns"), ("gru", 8, 128, "cluster"),
                   ("gru", 8, 512, "columns"), ("gru", 15, 1024, "cluster"), ("lstm", 1, 128, "cluster"),
                   ("lstm", 2, 512, "cluster"), ("lstm", 8, 128, "columns"), ("lstm", 8, 512, "columns"),
                   ("lstm", 15, 1024, "columns")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,G,B,kernel", XP_FP32_WINNERS,
                         ids=[f"{c}-G{g}B{b}" for c, g, b, _ in XP_FP32_WINNERS])
def test_xp_fwd_fp32_plan_takes_the_faster_kernel_on_card(cell, G, B, kernel):
    """The xproj forwards' fp32 plan takes, at H=256, the kernel the card
    timed faster there, and that kernel matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the sweep was timed on an H100 SXM (132 SMs)")
    _check_xp_fwd_layout(cell, G, B, 256, "any", kernel, False)


@pytest.mark.parametrize("plan", ["gru_xp_fwd_plan", "lstm_xp_fwd_plan"])
def test_xp_fwd_plans_refuse_without_the_card(plan):
    """A plan is the card's answer: it refuses H above 512 and, without a
    card, raises rather than guess a grid."""
    fn = getattr(gru_rnn if plan.startswith("gru") else lstm_rnn, plan)
    with pytest.raises(ValueError, match="H <= 512, got H=513"):
        fn(16, 128, 513)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            fn(16, 128, 256)
