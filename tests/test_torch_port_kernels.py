"""The port's GRU replay kernels and their plain versions, without JAX, so the
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

from rsl_rl_tpu_torch.ops import gru_rnn


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
