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
