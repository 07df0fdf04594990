"""LSTM window replay with done-masked resets: CUDA kernels, wrappers, plain version.

Math (flax ``OptimizedLSTMCell``, gates i|f|g|o, no input bias; ``c`` and
``h`` zeroed where ``resets[t]`` is set):

    a  = x Wx + h Wh + bh
    i, f, o = sigmoid(a_i), sigmoid(a_f), sigmoid(a_o);  g = tanh(a_g)
    c' = f * c + i * g
    h' = o * tanh(c')

Weights use the packed layout of the JAX package's ``_lstm_pack``: ``wx
[D,4H]``, ``wh [H,4H]``, ``bh [4H]``. A leading stream axis S runs
independent recurrences (S=2: the actor and critic memories of a PPO
minibatch) that share the reset mask.

Kernels (``csrc/lstm_x.cu``), one CUDA launch each:

- ``lstm_x_fwd`` replaces the Pallas ``_lstm_fwd_kernel_x_pair`` /
  ``_lstm_core_x_pair_fwd_impl`` (S=2) and ``_lstm_fwd_kernel_x`` /
  ``_lstm_core_x_fwd_impl`` (S=1) of ``rsl_rl_tpu/ops/pallas_rnn.py``; it
  writes ``hs`` and ``cs``.
- ``lstm_x_bwd`` and ``lstm_x_wgrad`` together replace
  ``_lstm_bwd_kernel_x_pair`` / ``_lstm_core_x_pair_bwd_impl`` and
  ``_lstm_bwd_kernel_x`` / ``_lstm_core_x_bwd_impl``. ``lstm_x_bwd`` runs the
  reverse-time BPTT chain, recomputing the gates from ``(cs, hs)[t-1]``, and
  writes each step's gate gradients ``di|df|dg|do`` to a scratch buffer;
  ``lstm_x_wgrad`` reduces them into ``dWh | dWx | dbh`` with the same
  split-K kernel as ``gru_x_wgrad`` (``csrc/rnn_wgrad.cuh``).

What bounds them on an H100 is what bounds the GRU kernels
(``ops/gru_rnn.py``): ``T`` dependent steps of ``[B,H] x [H,4H]`` in IEEE
fp32 on the CUDA cores, with ``Wh`` (1 MiB in fp32 at H=256, more than a
block's 227 KB of shared memory) re-read from L2 at every step. Each block
owns a tile of ``BB`` batch rows of one stream, keeps its hidden tile in
shared memory and its own ``c`` and ``h`` columns in registers.

On a CPU tensor the wrappers take the plain PyTorch version; on a CUDA tensor
they launch the kernels or raise. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from rsl_rl_tpu_torch.ops.rnn_common import (
    LaunchCounts,
    check,
    check_hidden,
    check_replay_inputs,
    is_bf16,
    load_kernels,
    mm,
    raise_on,
    stream,
    wgrad_splits,
)

launch_counts = LaunchCounts()


# --------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the kernels' reference on the card)
# --------------------------------------------------------------------------


def _gates(wx, wh, bh, h, x, bf16):
    H = wh.shape[-2]
    a = mm(x, wx, bf16) + mm(h, wh, bf16) + bh[:, None, :]
    i = torch.sigmoid(a[..., :H])
    f = torch.sigmoid(a[..., H : 2 * H])
    g = torch.tanh(a[..., 2 * H : 3 * H])
    o = torch.sigmoid(a[..., 3 * H :])
    return i, f, g, o


def lstm_x_plain_fwd(wx, wh, bh, c0, h0, xs, resets, bf16: bool = False):
    """Plain forward: ``xs [S,T,B,D]``, ``resets [T,B]`` float, ``c0, h0
    [S,B,H]``, ``wx [S,D,4H]``, ``wh [S,H,4H]``, ``bh [S,4H]`` -> ``(hs, cs)``,
    each ``[S,T,B,H]``."""
    keep = 1.0 - resets
    c, h = c0, h0
    hs, cs = [], []
    for t in range(xs.shape[1]):
        k = keep[t][None, :, None]
        c, h = c * k, h * k
        i, f, g, o = _gates(wx, wh, bh, h, xs[:, t], bf16)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def lstm_x_plain_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, bf16: bool = False):
    """Plain reverse-time BPTT chain of :func:`lstm_x_plain_fwd` for the output
    gradient ``ghs`` (the plain version of ``lstm_x_bwd``).

    Returns ``(dx, dc0, dh0, gscratch)`` with ``gscratch [S,T,B,4H]`` holding
    each step's ``di | df | dg | do``. Gate activations are recomputed from
    ``(cs, hs)[t-1]`` (``(c0, h0)`` at t=0) with the forward's operand
    rounding; the new cell state is ``cs[t]``.
    """
    S, T, B, _ = xs.shape
    H = h0.shape[-1]
    keep = 1.0 - resets
    dx = torch.empty_like(xs)
    gscratch = torch.empty((S, T, B, 4 * H), dtype=xs.dtype, device=xs.device)
    dh = torch.zeros_like(h0)
    dc = torch.zeros_like(c0)
    for t in reversed(range(T)):
        k = keep[t][None, :, None]
        c_prev = (c0 if t == 0 else cs[:, t - 1]) * k
        h_prev = (h0 if t == 0 else hs[:, t - 1]) * k
        i, f, g, o = _gates(wx, wh, bh, h_prev, xs[:, t], bf16)
        tc = torch.tanh(cs[:, t])
        gh = ghs[:, t] + dh
        gc = dc + gh * o * (1.0 - tc * tc)
        dgates = torch.cat([
            gc * g * i * (1.0 - i),
            gc * c_prev * f * (1.0 - f),
            gc * i * (1.0 - g * g),
            gh * tc * o * (1.0 - o),
        ], dim=-1)
        gscratch[:, t] = dgates
        dx[:, t] = mm(dgates, wx.transpose(-1, -2), bf16)
        dh = mm(dgates, wh.transpose(-1, -2), bf16) * k
        dc = gc * f * k
    return dx, dc, dh, gscratch


def lstm_x_plain_wgrad(xs, resets, h0, hs, gscratch, bf16: bool = False):
    """Plain weight-gradient reduction (the plain version of ``lstm_x_wgrad``):
    sums over all ``T*B`` rows of ``h_maskedᵀ dgates``, ``xᵀ dgates`` and
    ``dgates``. Returns ``(dwx, dwh, dbh)``."""
    S, T, B, D = xs.shape
    H = h0.shape[-1]
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1) * (1.0 - resets)[None, :, :, None]
    G = gscratch.reshape(S, T * B, 4 * H)
    dwh = mm(h_prev.reshape(S, T * B, H).transpose(-1, -2), G, bf16)
    dwx = mm(xs.reshape(S, T * B, D).transpose(-1, -2), G, bf16)
    return dwx, dwh, G.sum(dim=1)


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lstm_x_fwd": [_P] * 9 + [_I] * 6 + [_P],
    "lstm_x_bwd": [_P] * 15 + [_I] * 6 + [_P],
    "lstm_x_wgrad": [_P] * 7 + [_I] * 7 + [_P],
}
_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = load_kernels("lstm_x", _SIGNATURES)
    return _LIB


def _dims(wx, xs):
    S, T, B, D = xs.shape
    H = wx.shape[-1] // 4
    check_hidden("LSTM", H)
    return S, T, B, D, H


def _input_ptrs(wx, wh, bh, c0, h0, xs, resets):
    S, T, B, D, H = _dims(wx, xs)
    return [
        check("xs", xs, (S, T, B, D)),
        check("resets", resets, (T, B)),
        check("c0", c0, (S, B, H)),
        check("h0", h0, (S, B, H)),
        check("wx", wx, (S, D, 4 * H)),
        check("wh", wh, (S, H, 4 * H)),
    ]


def lstm_x_fwd(wx, wh, bh, c0, h0, xs, resets, bf16: bool = False):
    """Launch the forward kernel; shapes as :func:`lstm_x_plain_fwd`.
    Returns ``(hs, cs)``."""
    S, T, B, D, H = _dims(wx, xs)
    ptrs = _input_ptrs(wx, wh, bh, c0, h0, xs, resets) + [check("bh", bh, (S, 4 * H))]
    hs = torch.empty((S, T, B, H), dtype=torch.float32, device=xs.device)
    cs = torch.empty_like(hs)
    raise_on("lstm_x_fwd", _lib().lstm_x_fwd(*ptrs, hs.data_ptr(), cs.data_ptr(),
                                             S, T, B, D, H, int(bf16), stream()))
    launch_counts.fwd_launches += 1
    return hs, cs


def lstm_x_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, bf16: bool = False):
    """Launch the reverse-time BPTT kernel.

    Returns ``(dx, dc0, dh0, gscratch)``; ``gscratch [S,T,B,4H]`` holds each
    step's ``di | df | dg | do`` rows for :func:`lstm_x_wgrad`.
    """
    S, T, B, D, H = _dims(wx, xs)
    whT = wh.transpose(-1, -2).contiguous()  # [S,4H,H]: coalesced dgates @ Whᵀ
    ptrs = _input_ptrs(wx, wh, bh, c0, h0, xs, resets) + [
        check("whT", whT, (S, 4 * H, H)),
        check("bh", bh, (S, 4 * H)),
        check("hs", hs, (S, T, B, H)),
        check("cs", cs, (S, T, B, H)),
        check("ghs", ghs, (S, T, B, H)),
    ]
    dx = torch.empty_like(xs)
    dc0 = torch.empty_like(c0)
    dh0 = torch.empty_like(h0)
    gscratch = torch.empty((S, T, B, 4 * H), dtype=torch.float32, device=xs.device)
    out = [dx.data_ptr(), dc0.data_ptr(), dh0.data_ptr(), gscratch.data_ptr()]
    raise_on("lstm_x_bwd", _lib().lstm_x_bwd(*ptrs, *out, S, T, B, D, H, int(bf16), stream()))
    launch_counts.bwd_launches += 1
    return dx, dc0, dh0, gscratch


def lstm_x_wgrad(xs, resets, h0, hs, gscratch, bf16: bool = False):
    """Launch the weight-gradient reduction; returns ``(dwx, dwh, dbh)``.

    The kernel computes ``C = Σ_rows [h_masked | x | 1]ᵀ · [di | df | dg | do]``
    over the ``T*B`` rows, ``C [S, H+D+1, 4H]``; the gradients are slices of it.
    """
    S, T, B, D = xs.shape
    H = h0.shape[-1]
    ptrs = [
        check("xs", xs, (S, T, B, D)),
        check("resets", resets, (T, B)),
        check("h0", h0, (S, B, H)),
        check("hs", hs, (S, T, B, H)),
        check("gscratch", gscratch, (S, T, B, 4 * H)),
    ]
    P = wgrad_splits(T * B)
    W = torch.empty((S, P, H + D + 1, 4 * H), dtype=torch.float32, device=xs.device)
    C = torch.empty((S, H + D + 1, 4 * H), dtype=torch.float32, device=xs.device)
    raise_on("lstm_x_wgrad", _lib().lstm_x_wgrad(*ptrs, W.data_ptr(), C.data_ptr(), S, T, B, D, H, P,
                                                 int(bf16), stream()))
    launch_counts.wgrad_launches += 1
    return C[:, H : H + D].contiguous(), C[:, :H].contiguous(), C[:, H + D].contiguous()


# --------------------------------------------------------------------------
# autograd and public API
# --------------------------------------------------------------------------


class _LstmX(torch.autograd.Function):
    """``(hs, cT)``; ``cT`` (the cell state after the last step) is value-only,
    like the JAX package's ``_lstm_core_x``."""

    @staticmethod
    def forward(ctx, wx, wh, bh, c0, h0, xs, resets, bf16):
        if xs.is_cuda:
            hs, cs = lstm_x_fwd(wx, wh, bh, c0, h0, xs, resets, bf16)
        else:
            hs, cs = lstm_x_plain_fwd(wx, wh, bh, c0, h0, xs, resets, bf16)
        ctx.save_for_backward(wx, wh, bh, c0, h0, xs, resets, hs, cs)
        ctx.bf16 = bf16
        cT = cs[:, -1].clone()
        ctx.mark_non_differentiable(cT)
        return hs, cT

    @staticmethod
    def backward(ctx, ghs, _gcT):
        wx, wh, bh, c0, h0, xs, resets, hs, cs = ctx.saved_tensors
        ghs = ghs.contiguous()
        if xs.is_cuda:
            dx, dc0, dh0, gscratch = lstm_x_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, ctx.bf16)
            dwx, dwh, dbh = lstm_x_wgrad(xs, resets, h0, hs, gscratch, ctx.bf16)
        else:
            dx, dc0, dh0, gscratch = lstm_x_plain_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, ctx.bf16)
            dwx, dwh, dbh = lstm_x_plain_wgrad(xs, resets, h0, hs, gscratch, ctx.bf16)
        return dwx, dwh, dbh, dc0, dh0, dx, None, None


def _lstm_x_streams(params_list, carry0_list, xs_list, resets, compute_dtype):
    """``(hs [S,T,B,H], cT [S,B,H])`` of S replays in one launch per kernel."""
    T, B, D = xs_list[0].shape
    tensors = [t for p in params_list for t in p.values()] + [t for c in carry0_list for t in c]
    check_replay_inputs("LSTM", tensors + [*xs_list, resets], D, xs_list[0].is_cuda)
    f32 = torch.float32
    wx = torch.stack([p["wx"] for p in params_list]).to(f32)
    wh = torch.stack([p["wh"] for p in params_list]).to(f32)
    bh = torch.stack([p["bh"] for p in params_list]).to(f32)
    c0 = torch.stack([c for c, _ in carry0_list]).to(f32)
    h0 = torch.stack([h for _, h in carry0_list]).to(f32)
    xs = torch.stack(list(xs_list)).to(f32)
    resets = resets.to(f32).reshape(T, B).contiguous()
    return _LstmX.apply(wx, wh, bh, c0, h0, xs, resets, is_bf16(compute_dtype))


def lstm_step(params: dict, carry, x: torch.Tensor, compute_dtype=None):
    """One LSTM step, ``carry = (c, h)`` each ``[N,H]``, ``x [N,D]`` ->
    ``(c', h')``, with the same math and operand rounding as the replay
    (the JAX package's ``lstm_step_mixed``), so acting and replay agree.
    Plain PyTorch on every device: acting runs one step at a time."""
    c, h = carry
    i, f, g, o = _gates(params["wx"][None], params["wh"][None], params["bh"][None],
                        h[None], x[None], is_bf16(compute_dtype))
    c_new = f[0] * c + i[0] * g[0]
    return c_new, o[0] * torch.tanh(c_new)


def lstm_sequence_with_carry(params: dict, carry0, xs: torch.Tensor, resets: torch.Tensor,
                             compute_dtype=None):
    """Replay one LSTM over a window, ``xs [T,B,D]`` -> ``(hs [T,B,H], (cT, hT))``.

    ``params`` holds the packed ``wx``, ``wh``, ``bh``; ``carry0 = (c0, h0)``,
    each ``[B,H]``, enters step 0; ``resets [T,B]`` zeroes the carry before
    step ``t``. ``compute_dtype`` is ``None`` (IEEE fp32) or
    ``torch.bfloat16`` (bf16 matmul operands, fp32 accumulation and state).
    ``hs`` is differentiable in ``params``, ``carry0`` and ``xs``; the final
    carry is value-only (detached), for truncated-BPTT replay.
    """
    hs, cT = _lstm_x_streams([params], [carry0], [xs], resets, compute_dtype)
    return hs[0], (cT[0], hs[0, -1].detach())


def lstm_sequence_x(params: dict, carry0, xs: torch.Tensor, resets: torch.Tensor,
                    compute_dtype=None) -> torch.Tensor:
    """:func:`lstm_sequence_with_carry` without the final carry: ``hs [T,B,H]``."""
    return lstm_sequence_with_carry(params, carry0, xs, resets, compute_dtype)[0]


def lstm_sequence_pair(params_pair, carry0_pair, xs_pair, resets: torch.Tensor,
                       compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent LSTM replays with shared resets in one launch per
    kernel; equal to two :func:`lstm_sequence_x` calls. ``carry0_pair`` holds
    each stream's ``(c0, h0)``. Returns ``(hs_a, hs_b)``."""
    hs, _ = _lstm_x_streams(list(params_pair), list(carry0_pair), list(xs_pair), resets, compute_dtype)
    return hs[0], hs[1]
