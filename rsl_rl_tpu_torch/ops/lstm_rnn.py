"""LSTM window replay with done-masked resets: CUDA kernels, wrappers, plain version.

Math (flax ``OptimizedLSTMCell``, gates i|f|g|o, no input bias; ``c`` and
``h`` zeroed where ``resets[t]`` is set):

    a  = x Wx + h Wh + bh
    i, f, o = sigmoid(a_i), sigmoid(a_f), sigmoid(a_o);  g = tanh(a_g)
    c' = f * c + i * g
    h' = o * tanh(c')

Weights use the packed layout of the JAX package's ``_lstm_pack``: ``wx
[D,4H]``, ``wh [H,4H]``, ``bh [4H]``. A leading stream axis runs independent
recurrences.

Two kernel sets, one CUDA launch each, as in the JAX package:

- x-streaming (``csrc/lstm_x.cu``), S streams that share the reset mask (S=2:
  the actor and critic memories of a PPO minibatch). ``lstm_x_fwd`` replaces
  the Pallas ``_lstm_fwd_kernel_x_pair`` / ``_lstm_core_x_pair_fwd_impl``
  (S=2) and ``_lstm_fwd_kernel_x`` / ``_lstm_core_x_fwd_impl`` (S=1) of
  ``rsl_rl_tpu/ops/pallas_rnn.py``; it writes ``hs`` and ``cs``.
  ``lstm_x_bwd`` and ``lstm_x_wgrad`` together replace
  ``_lstm_bwd_kernel_x_pair`` / ``_lstm_core_x_pair_bwd_impl`` and
  ``_lstm_bwd_kernel_x`` / ``_lstm_core_x_bwd_impl``. ``lstm_x_bwd`` runs the
  reverse-time BPTT chain, recomputing the gates from ``(cs, hs)[t-1]``, and
  writes each step's gate gradients ``di|df|dg|do`` to a scratch buffer;
  ``lstm_x_wgrad`` reduces them into ``dWh | dWx | dbh`` with the same
  split-K kernel as ``gru_x_wgrad`` (``csrc/rnn_wgrad.cuh``).
- xproj-streaming (``csrc/lstm_xp.cu``), G streams with a reset mask each,
  over ``xproj = x Wx`` computed outside the kernels in one bulk product per
  stream. ``lstm_xp_fwd`` replaces ``_lstm_fwd_kernel`` /
  ``_lstm_core_fwd_impl``; ``lstm_xp_bwd`` and ``lstm_xp_wgrad`` replace
  ``_lstm_bwd_kernel`` / ``_lstm_core_bwd_impl`` (the gate gradients are the
  gradient of ``xproj``; the reduction gives ``dWh | dbh``). They serve
  inputs wider than ``X_STREAM_MAX_D`` (G=1) and every replay under
  ``torch.func.vmap``, the seed axis of multi-seed training: the x-streaming
  replay's vmap rule folds the seed and stream axes into G and takes them.

What bounds the kernels on an H100 is what bounds the GRU kernels
(``ops/gru_rnn.py``): ``T`` dependent steps of ``[B,H] x [H,4H]`` in IEEE
fp32 on the CUDA cores, with ``Wh`` 1 MiB in fp32 at H=256, more than a
block's 227 KB of shared memory. ``lstm_x_fwd`` spreads it over a
thread-block cluster of 8 CTAs instead: each CTA keeps the four gates of its
H/8 hidden columns of ``[Wh; Wx]`` in shared memory for the whole window
(bf16 mode: rounded once when staged), computes its rows' gates at each step
as one tiled product (tensor cores in bf16 mode), keeps ``c`` to itself and
exchanges ``h`` through ``hs`` with a cluster barrier between steps; the grid
takes as many clusters as the card runs at once (the cluster forward of
``csrc/rnn_fwd.cuh``, shared with ``gru_x_fwd``). Where the slice does not
fit (H > 256) the same kernel streams it from L2 at every step.
``lstm_xp_fwd`` runs the same cluster forward over the stored ``xproj`` (the
``Wh`` rows alone, each gate's accumulator starting at its ``xproj`` element
and ``bh``) with a reset mask a stream; where the streams outnumber the
clusters the card runs at once, a cluster serves whole streams and a share
of the rest, its CTAs holding each one's weight slice, so G=16 streams run
in one wave in bf16 mode (with a cluster a stream, 16 clusters on a card
that runs 15 would take two). In fp32 mode the plan keeps one block per
``BB`` batch rows of one stream, its hidden tile in shared memory and its
own ``c`` and ``h`` columns in registers (above H=256 two columns a thread),
re-reading ``Wh`` from L2 at every step, where its step would cost less than
the cluster forward's, by the costs timed on an H100 (``XpFp32Cost``,
``csrc/rnn_fwd.cuh``): G=16 (two fp32 slices do not fit a CTA) and any full
128-row fp32 tile a cluster go to it; one stream (the wide-input path, 69
rows a cluster in one 80-row tile) and small tiles to the cluster forward.
``lstm_x_bwd`` and ``lstm_xp_bwd`` take out of the serial chain what does
not depend on the carried gradients, in the three phases of
``csrc/rnn_bwd.cuh``: the gates of all steps in one tiled GEMM over the
``T*B`` rows (``lstm_xp_bwd``: over all ``G*T*B`` rows, adding the stored
``xproj`` row where ``lstm_x_bwd`` multiplies ``x Wx``), then per step one
launch of ``dgates @ Whᵀ`` tiled over the whole card (each ``Whᵀ`` element
read from L2 serves 64 rows) with the cell's elementwise gradient in its
epilogue, then ``dx`` for all steps at once (``lstm_xp_bwd`` has no such
phase: its gate gradients are the gradient of ``xproj``). In bf16 mode their
products and the reduction's run on the tensor cores.

On a CPU tensor the wrappers take the plain PyTorch version; on a CUDA tensor
they launch the kernels or raise. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from rsl_rl_tpu_torch.ops.rnn_common import (
    X_STREAM_MAX_D,
    batch_first,
    check,
    check_hidden,
    check_replay_inputs,
    check_resets,
    fwd_plan,
    is_bf16,
    load_kernels,
    marked,
    merge_streams,
    mm,
    op,
    raise_on,
    shared_resets,
    stream,
    wgrad_scratch,
)
from rsl_rl_tpu_torch.utils import trace
from rsl_rl_tpu_torch.utils.trace import LaunchCounts

#: launches of the x-streaming kernels (``lstm_x_*``) and of the xproj kernels (``lstm_xp_*``)
launch_counts = LaunchCounts()
xp_launch_counts = LaunchCounts()


# --------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the kernels' reference on the card)
# --------------------------------------------------------------------------


def _gates(xp, wh, bh, h, bf16):
    """i, f, g, o of one step from its input projection ``xp = x Wx``."""
    H = wh.shape[-2]
    a = xp + mm(h, wh, bf16) + bh[:, None, :]
    i = torch.sigmoid(a[..., :H])
    f = torch.sigmoid(a[..., H : 2 * H])
    g = torch.tanh(a[..., 2 * H : 3 * H])
    o = torch.sigmoid(a[..., 3 * H :])
    return i, f, g, o


def input_projection(wx, xs, bf16: bool = False) -> torch.Tensor:
    """``xs [S,T,B,D] @ wx [S,D,4H]`` -> ``[S,T,B,4H]`` (no input bias): one
    bulk product per stream with the replay's operand rounding (differentiable)."""
    S, T, B, D = xs.shape
    return torch.bmm(op(xs.reshape(S, T * B, D), bf16), op(wx, bf16)).reshape(S, T, B, -1)


def lstm_xp_plain_fwd(wh, bh, c0, h0, xproj, resets, bf16: bool = False):
    """Plain xproj forward: ``xproj [G,T,B,4H]``, ``resets [G,T,B]`` float,
    ``c0, h0 [G,B,H]``, ``wh [G,H,4H]``, ``bh [G,4H]`` -> ``(hs, cs)``, each
    ``[G,T,B,H]``."""
    keep = 1.0 - resets
    c, h = c0, h0
    hs, cs = [], []
    for t in range(xproj.shape[1]):
        k = keep[:, t, :, None]
        c, h = c * k, h * k
        i, f, g, o = _gates(xproj[:, t], wh, bh, h, bf16)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def lstm_xp_plain_bwd(wh, bh, c0, h0, xproj, resets, hs, cs, ghs, bf16: bool = False):
    """Plain reverse-time BPTT chain of :func:`lstm_xp_plain_fwd` for the
    output gradient ``ghs`` (the plain version of ``lstm_xp_bwd``).

    Returns ``(dc0, dh0, gscratch)`` with ``gscratch [G,T,B,4H]`` holding each
    step's ``di | df | dg | do``, which is also the gradient of ``xproj``.
    In the phases of ``lstm_x_bwd``: the gate activations of every step at
    once, recomputed from ``(cs, hs)[t-1]`` (``(c0, h0)`` at t=0) with the
    forward's operand rounding (the new cell state is ``cs[t]``); then the
    chain, whose only product is ``dgates @ Whᵀ``.
    """
    G, T, B, _ = xproj.shape
    H = h0.shape[-1]
    keep = (1.0 - resets)[..., None]
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1) * keep
    c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1) * keep
    i, f, g, o = _gates(xproj.reshape(G, T * B, 4 * H), wh, bh, h_prev.reshape(G, T * B, H), bf16)
    i, f, g, o = (v.reshape(G, T, B, H) for v in (i, f, g, o))
    tc = torch.tanh(cs)
    gscratch = torch.empty((G, T, B, 4 * H), dtype=xproj.dtype, device=xproj.device)
    dh = torch.zeros_like(h0)
    dc = torch.zeros_like(c0)
    for t in reversed(range(T)):
        gh = ghs[:, t] + dh
        gc = dc + gh * o[:, t] * (1.0 - tc[:, t] * tc[:, t])
        dgates = torch.cat([
            gc * g[:, t] * i[:, t] * (1.0 - i[:, t]),
            gc * c_prev[:, t] * f[:, t] * (1.0 - f[:, t]),
            gc * i[:, t] * (1.0 - g[:, t] * g[:, t]),
            gh * tc[:, t] * o[:, t] * (1.0 - o[:, t]),
        ], dim=-1)
        gscratch[:, t] = dgates
        dh = mm(dgates, wh.transpose(-1, -2), bf16) * keep[:, t]
        dc = gc * f[:, t] * keep[:, t]
    return dc, dh, gscratch


def lstm_xp_plain_wgrad(resets, h0, hs, gscratch, bf16: bool = False):
    """Plain weight-gradient reduction (the plain version of ``lstm_xp_wgrad``):
    sums over all ``T*B`` rows of ``h_maskedᵀ dgates`` and ``dgates``.
    Returns ``(dwh, dbh)``."""
    G, T, B = resets.shape
    H = h0.shape[-1]
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1) * (1.0 - resets)[..., None]
    gs = gscratch.reshape(G, T * B, 4 * H)
    return mm(h_prev.reshape(G, T * B, H).transpose(-1, -2), gs, bf16), gs.sum(dim=1)


def lstm_x_plain_fwd(wx, wh, bh, c0, h0, xs, resets, bf16: bool = False):
    """Plain forward: ``xs [S,T,B,D]``, ``resets [T,B]`` float, ``c0, h0
    [S,B,H]``, ``wx [S,D,4H]``, ``wh [S,H,4H]``, ``bh [S,4H]`` -> ``(hs, cs)``,
    each ``[S,T,B,H]``."""
    xproj = input_projection(wx, xs, bf16)
    return lstm_xp_plain_fwd(wh, bh, c0, h0, xproj, shared_resets(resets, xs.shape[0]), bf16)


def lstm_x_plain_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, bf16: bool = False):
    """Plain reverse-time BPTT chain of :func:`lstm_x_plain_fwd` for the output
    gradient ``ghs`` (the plain version of ``lstm_x_bwd``).

    Returns ``(dx, dc0, dh0, gscratch)`` with ``gscratch [S,T,B,4H]`` holding
    each step's ``di | df | dg | do``, and ``dx = dgates Wxᵀ``, the third
    phase, over all steps at once.
    """
    xproj = input_projection(wx, xs, bf16)
    dc0, dh0, gscratch = lstm_xp_plain_bwd(wh, bh, c0, h0, xproj, shared_resets(resets, xs.shape[0]),
                                           hs, cs, ghs, bf16)
    dx = mm(gscratch, wx.transpose(-1, -2)[:, None], bf16)
    return dx, dc0, dh0, gscratch


def lstm_x_plain_wgrad(xs, resets, h0, hs, gscratch, bf16: bool = False):
    """Plain weight-gradient reduction (the plain version of ``lstm_x_wgrad``):
    sums over all ``T*B`` rows of ``h_maskedᵀ dgates``, ``xᵀ dgates`` and
    ``dgates``. Returns ``(dwx, dwh, dbh)``."""
    S, T, B, D = xs.shape
    H = h0.shape[-1]
    dwh, dbh = lstm_xp_plain_wgrad(shared_resets(resets, S), h0, hs, gscratch, bf16)
    dwx = mm(xs.reshape(S, T * B, D).transpose(-1, -2), gscratch.reshape(S, T * B, 4 * H), bf16)
    return dwx, dwh, dbh


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lstm_x": {
        "lstm_x_fwd": [_P] * 9 + [_I] * 6 + [_P],
        "lstm_x_bwd": [_P] * 15 + [_I] * 6 + [_P] * 2,
        "lstm_x_fwd_plan": [_I] * 5 + [_P],
        "lstm_x_wgrad": [_P] * 7 + [_I] * 7 + [_P],
    },
    "lstm_xp": {
        "lstm_xp_fwd": [_P] * 8 + [_I] * 5 + [_P],
        "lstm_xp_fwd_plan": [_I] * 4 + [_P],
        "lstm_xp_bwd": [_P] * 13 + [_I] * 5 + [_P] * 2,
        "lstm_xp_wgrad": [_P] * 6 + [_I] * 6 + [_P],
    },
}
_LIBS: dict[str, ctypes.CDLL] = {}


def _lib(name: str = "lstm_x") -> ctypes.CDLL:
    if name not in _LIBS:
        _LIBS[name] = load_kernels(name, _SIGNATURES[name])
    return _LIBS[name]


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
    with trace.interval("memory"):
        raise_on("lstm_x_fwd", _lib().lstm_x_fwd(*ptrs, hs.data_ptr(), cs.data_ptr(),
                                                 S, T, B, D, H, int(bf16), stream()))
    launch_counts.fwd_launches += 1
    return hs, cs


def lstm_x_fwd_plan(S: int, B: int, D: int, H: int, bf16: bool = False) -> dict:
    """The grid :func:`lstm_x_fwd` chooses on the current card for these
    shapes: the clusters the card runs at once, the batch rows of a cluster,
    the clusters launched, whether the weight slices stay in shared memory,
    the rows of the tiles that take a cluster's rows past its full 128-row
    tiles, the CTAs of a cluster and the waves."""
    check_hidden("LSTM", H)
    return fwd_plan("lstm_x_fwd_plan", _lib().lstm_x_fwd_plan, S, B, D, H, int(bf16))


def _lstm_x_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, bf16, phase_ms):
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
    with trace.interval("memory"):
        raise_on("lstm_x_bwd", _lib().lstm_x_bwd(*ptrs, *out, S, T, B, D, H, int(bf16), stream(), phase_ms))
    launch_counts.bwd_launches += 1
    return dx, dc0, dh0, gscratch


def lstm_x_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, bf16: bool = False):
    """Launch the reverse-time BPTT kernels (the three phases of
    ``csrc/rnn_bwd.cuh``).

    Returns ``(dx, dc0, dh0, gscratch)``; ``gscratch [S,T,B,4H]`` holds each
    step's ``di | df | dg | do`` rows for :func:`lstm_x_wgrad`.
    """
    return _lstm_x_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, bf16, None)


def lstm_x_bwd_phase_ms(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, bf16: bool = False):
    """One :func:`lstm_x_bwd` call timed by CUDA events between its phases
    (waits for the stream): ``(gates ms, chain ms, dx ms)``."""
    ms = (ctypes.c_float * 3)()
    _lstm_x_bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, bf16, ctypes.addressof(ms))
    return tuple(ms)


def lstm_x_wgrad(xs, resets, h0, hs, gscratch, bf16: bool = False):
    """Launch the weight-gradient reduction; returns ``(dwx, dwh, dbh)``.

    The kernel computes ``C = Σ_rows [h_masked | x | 1]ᵀ · [di | df | dg | do]``
    over the ``T*B`` rows, ``C [S, H+D+1, 4H]``; the gradients are slices of it.
    """
    S, T, B, D = xs.shape
    H = h0.shape[-1]
    check_hidden("LSTM", H)
    ptrs = [
        check("xs", xs, (S, T, B, D)),
        check("resets", resets, (T, B)),
        check("h0", h0, (S, B, H)),
        check("hs", hs, (S, T, B, H)),
        check("gscratch", gscratch, (S, T, B, 4 * H)),
    ]
    P, W, C = wgrad_scratch(S, T, B, D, H, xs.device, bf16)
    with trace.interval("memory"):
        raise_on("lstm_x_wgrad", _lib().lstm_x_wgrad(*ptrs, W.data_ptr(), C.data_ptr(), S, T, B, D, H, P,
                                                     int(bf16), stream()))
    launch_counts.wgrad_launches += 1
    return C[:, H : H + D].contiguous(), C[:, :H].contiguous(), C[:, H + D].contiguous()


def _xp_dims(wh, xproj):
    G, T, B, _ = xproj.shape
    H = wh.shape[-2]
    check_hidden("LSTM", H)
    return G, T, B, H


def _xp_input_ptrs(wh, bh, c0, h0, xproj, resets):
    G, T, B, H = _xp_dims(wh, xproj)
    return [
        check("xproj", xproj, (G, T, B, 4 * H)),
        check("resets", resets, (G, T, B)),
        check("c0", c0, (G, B, H)),
        check("h0", h0, (G, B, H)),
        check("wh", wh, (G, H, 4 * H)),
    ]


def lstm_xp_fwd(wh, bh, c0, h0, xproj, resets, bf16: bool = False):
    """Launch the xproj forward kernel (the cluster forward of
    ``csrc/rnn_fwd.cuh``, or one thread a hidden column where
    :func:`lstm_xp_fwd_plan` says so); shapes as :func:`lstm_xp_plain_fwd`.
    Returns ``(hs, cs)``."""
    G, T, B, H = _xp_dims(wh, xproj)
    ptrs = _xp_input_ptrs(wh, bh, c0, h0, xproj, resets) + [check("bh", bh, (G, 4 * H))]
    hs = torch.empty((G, T, B, H), dtype=torch.float32, device=xproj.device)
    cs = torch.empty_like(hs)
    with trace.interval("memory"):
        raise_on("lstm_xp_fwd", _lib("lstm_xp").lstm_xp_fwd(*ptrs, hs.data_ptr(), cs.data_ptr(),
                                                             G, T, B, H, int(bf16), stream()))
    xp_launch_counts.fwd_launches += 1
    return hs, cs


def lstm_xp_fwd_plan(G: int, B: int, H: int, bf16: bool = False) -> dict:
    """The grid :func:`lstm_xp_fwd` chooses on the current card for G streams
    of B rows: the cluster forward's (``"kernel": "cluster"``, keys as
    :func:`lstm_x_fwd_plan`; ``parts``: the streams a cluster serves at most),
    or ``{"kernel": "columns"}`` (fp32 mode where one thread a column costs
    less, or the weight slices would stream from L2)."""
    check_hidden("LSTM", H)
    return fwd_plan("lstm_xp_fwd_plan", _lib("lstm_xp").lstm_xp_fwd_plan, G, B, H, int(bf16))


def _lstm_xp_bwd(wh, bh, c0, h0, xproj, resets, hs, cs, ghs, bf16, phase_ms):
    G, T, B, H = _xp_dims(wh, xproj)
    whT = wh.transpose(-1, -2).contiguous()  # [G,4H,H]: coalesced dgates @ Whᵀ
    ptrs = _xp_input_ptrs(wh, bh, c0, h0, xproj, resets) + [
        check("whT", whT, (G, 4 * H, H)),
        check("bh", bh, (G, 4 * H)),
        check("hs", hs, (G, T, B, H)),
        check("cs", cs, (G, T, B, H)),
        check("ghs", ghs, (G, T, B, H)),
    ]
    dc0 = torch.empty_like(c0)
    dh0 = torch.empty_like(h0)
    gscratch = torch.empty((G, T, B, 4 * H), dtype=torch.float32, device=xproj.device)
    out = [dc0.data_ptr(), dh0.data_ptr(), gscratch.data_ptr()]
    with trace.interval("memory"):
        raise_on("lstm_xp_bwd", _lib("lstm_xp").lstm_xp_bwd(*ptrs, *out, G, T, B, H, int(bf16), stream(), phase_ms))
    xp_launch_counts.bwd_launches += 1
    return dc0, dh0, gscratch


def lstm_xp_bwd(wh, bh, c0, h0, xproj, resets, hs, cs, ghs, bf16: bool = False):
    """Launch the xproj BPTT kernels (the gates and chain phases of
    ``csrc/rnn_bwd.cuh``); returns ``(dc0, dh0, gscratch)`` as
    :func:`lstm_xp_plain_bwd`."""
    return _lstm_xp_bwd(wh, bh, c0, h0, xproj, resets, hs, cs, ghs, bf16, None)


def lstm_xp_bwd_phase_ms(wh, bh, c0, h0, xproj, resets, hs, cs, ghs, bf16: bool = False):
    """One :func:`lstm_xp_bwd` call timed by CUDA events between its phases
    (waits for the stream): ``(gates ms, chain ms, 0.0)``; the xproj backward
    has no dx phase."""
    ms = (ctypes.c_float * 3)()
    _lstm_xp_bwd(wh, bh, c0, h0, xproj, resets, hs, cs, ghs, bf16, ctypes.addressof(ms))
    return tuple(ms)


def lstm_xp_wgrad(resets, h0, hs, gscratch, bf16: bool = False):
    """Launch the xproj weight-gradient reduction; returns ``(dwh, dbh)``.

    The kernel computes ``C = Σ_rows [h_masked | 1]ᵀ · [di | df | dg | do]``
    over the ``T*B`` rows, ``C [G, H+1, 4H]``; the gradients are slices of it.
    """
    G, T, B = resets.shape
    H = h0.shape[-1]
    check_hidden("LSTM", H)
    ptrs = [
        check("resets", resets, (G, T, B)),
        check("h0", h0, (G, B, H)),
        check("hs", hs, (G, T, B, H)),
        check("gscratch", gscratch, (G, T, B, 4 * H)),
    ]
    P, W, C = wgrad_scratch(G, T, B, 0, H, hs.device, bf16)
    with trace.interval("memory"):
        raise_on("lstm_xp_wgrad", _lib("lstm_xp").lstm_xp_wgrad(*ptrs, W.data_ptr(), C.data_ptr(), G, T, B, H, P,
                                                                 int(bf16), stream()))
    xp_launch_counts.wgrad_launches += 1
    return C[:, :H].contiguous(), C[:, H].contiguous()


# --------------------------------------------------------------------------
# autograd and public API
# --------------------------------------------------------------------------


class _LstmXp(torch.autograd.Function):
    """``(hs, cT, cs)`` of G xproj replays (the JAX package's ``_lstm_core``);
    ``hs`` is differentiable in ``wh``, ``bh``, ``c0``, ``h0`` and ``xproj``;
    ``cT`` (the cell state after the last step) and ``cs`` (every step's, which
    the backward reads) are value-only."""

    @staticmethod
    def forward(wh, bh, c0, h0, xproj, resets, bf16):
        fwd = lstm_xp_fwd if xproj.is_cuda else marked(lstm_xp_plain_fwd)
        hs, cs = fwd(wh, bh, c0, h0, xproj, resets, bf16)
        return hs, cs[:, -1].clone(), cs

    @staticmethod
    def setup_context(ctx, inputs, output):
        wh, bh, c0, h0, xproj, resets, bf16 = inputs
        hs, cT, cs = output
        ctx.save_for_backward(wh, bh, c0, h0, xproj, resets, hs, cs)
        ctx.bf16 = bf16
        ctx.mark_non_differentiable(cT, cs)

    @staticmethod
    def backward(ctx, ghs, _gcT, _gcs):
        wh, bh, c0, h0, xproj, resets, hs, cs = ctx.saved_tensors
        ghs = ghs.contiguous()
        if xproj.is_cuda:
            bwd, wgrad = lstm_xp_bwd, lstm_xp_wgrad
        else:
            bwd, wgrad = marked(lstm_xp_plain_bwd), marked(lstm_xp_plain_wgrad)
        dc0, dh0, gscratch = bwd(wh, bh, c0, h0, xproj, resets, hs, cs, ghs, ctx.bf16)
        dwh, dbh = wgrad(resets, h0, hs, gscratch, ctx.bf16)
        return dwh, dbh, dc0, dh0, gscratch, None, None

    @staticmethod
    def vmap(info, in_dims, wh, bh, c0, h0, xproj, resets, bf16):
        """A vmapped axis V folds into the stream axis: one launch of V*G streams."""
        V = info.batch_size
        args = [merge_streams(batch_first(t, d, V)) for t, d in zip((wh, bh, c0, h0, xproj, resets), in_dims)]
        out = _LstmXp.apply(*args, bf16)
        return tuple(t.reshape(V, -1, *t.shape[1:]) for t in out), (0, 0, 0)


def _lstm_xproj(wx, wh, bh, c0, h0, xs, resets, bf16):
    """G xproj replays (fp32 tensors with a leading stream axis): the input
    projections in one bulk product, then the xproj kernels. ``(hs, cT, cs)``."""
    xproj = input_projection(wx, xs, bf16)
    return _LstmXp.apply(wh.contiguous(), bh.contiguous(), c0.contiguous(), h0.contiguous(), xproj,
                         resets.contiguous(), bf16)


class _LstmX(torch.autograd.Function):
    """``(hs, cT, cs)`` of S x-streaming replays that share the reset mask;
    ``cT`` (the cell state after the last step) is value-only, like the JAX
    package's ``_lstm_core_x``, and so is ``cs``, which the backward reads."""

    @staticmethod
    def forward(wx, wh, bh, c0, h0, xs, resets, bf16):
        fwd = lstm_x_fwd if xs.is_cuda else marked(lstm_x_plain_fwd)
        hs, cs = fwd(wx, wh, bh, c0, h0, xs, resets, bf16)
        return hs, cs[:, -1].clone(), cs

    @staticmethod
    def setup_context(ctx, inputs, output):
        wx, wh, bh, c0, h0, xs, resets, bf16 = inputs
        hs, cT, cs = output
        ctx.save_for_backward(wx, wh, bh, c0, h0, xs, resets, hs, cs)
        ctx.bf16 = bf16
        ctx.mark_non_differentiable(cT, cs)

    @staticmethod
    def backward(ctx, ghs, _gcT, _gcs):
        wx, wh, bh, c0, h0, xs, resets, hs, cs = ctx.saved_tensors
        ghs = ghs.contiguous()
        if xs.is_cuda:
            bwd, wgrad = lstm_x_bwd, lstm_x_wgrad
        else:
            bwd, wgrad = marked(lstm_x_plain_bwd), marked(lstm_x_plain_wgrad)
        dx, dc0, dh0, gscratch = bwd(wx, wh, bh, c0, h0, xs, resets, hs, cs, ghs, ctx.bf16)
        dwx, dwh, dbh = wgrad(xs, resets, h0, hs, gscratch, ctx.bf16)
        return dwx, dwh, dbh, dc0, dh0, dx, None, None

    @staticmethod
    def vmap(info, in_dims, wx, wh, bh, c0, h0, xs, resets, bf16):
        """Under ``torch.func.vmap`` (the seed axis of multi-seed training) the
        replay takes the xproj kernels, as the JAX package's replay does under
        ``jax.vmap``: the vmapped axis V and the stream axis S fold into the
        xproj kernels' stream axis, V*S streams with a reset mask each."""
        V = info.batch_size
        wx, wh, bh, c0, h0, xs, resets = (
            batch_first(t, d, V) for t, d in zip((wx, wh, bh, c0, h0, xs, resets), in_dims))
        S = xs.shape[1]
        resets = resets[:, None].expand(V, S, *resets.shape[1:])
        out = _lstm_xproj(*(merge_streams(t) for t in (wx, wh, bh, c0, h0, xs, resets)), bf16)
        return tuple(t.reshape(V, S, *t.shape[1:]) for t in out), (0, 0, 0)


def _lstm_x_streams(params_list, carry0_list, xs_list, resets, compute_dtype):
    """``(hs [S,T,B,H], cT [S,B,H])`` of S replays in one launch per kernel."""
    T, B, _ = xs_list[0].shape
    tensors = [t for p in params_list for t in p.values()] + [t for c in carry0_list for t in c]
    check_replay_inputs("LSTM", tensors + [*xs_list, resets])
    f32 = torch.float32
    wx = torch.stack([p["wx"] for p in params_list]).to(f32)
    wh = torch.stack([p["wh"] for p in params_list]).to(f32)
    bh = torch.stack([p["bh"] for p in params_list]).to(f32)
    c0 = torch.stack([c for c, _ in carry0_list]).to(f32)
    h0 = torch.stack([h for _, h in carry0_list]).to(f32)
    xs = torch.stack(list(xs_list)).to(f32)
    resets = resets.to(f32).reshape(T, B).contiguous()
    hs, cT, _ = _LstmX.apply(wx, wh, bh, c0, h0, xs, resets, is_bf16(compute_dtype))
    return hs, cT


def lstm_step(params: dict, carry, x: torch.Tensor, compute_dtype=None):
    """One LSTM step, ``carry = (c, h)`` each ``[N,H]``, ``x [N,D]`` ->
    ``(c', h')``, with the same math and operand rounding as the replay
    (the JAX package's ``lstm_step_mixed``), so acting and replay agree.
    Plain PyTorch on every device: acting runs one step at a time."""
    c, h = carry
    bf16 = is_bf16(compute_dtype)
    i, f, g, o = _gates(mm(x[None], params["wx"][None], bf16), params["wh"][None], params["bh"][None],
                        h[None], bf16)
    c_new = f[0] * c + i[0] * g[0]
    return c_new, o[0] * torch.tanh(c_new)


def lstm_sequence_xproj(params: dict, carry0, xs: torch.Tensor, resets: torch.Tensor,
                        compute_dtype=None):
    """G independent LSTM replays through the xproj kernels, ``xs [G,T,B,D]``
    -> ``(hs [G,T,B,H], cT [G,B,H])``.

    ``params`` holds the packed ``wx``, ``wh``, ``bh`` with a leading ``[G]``
    axis, ``carry0 = (c0, h0)`` each ``[G,B,H]``, ``resets [G,T,B]`` (each
    stream its own mask). The input projection is one bulk product per stream
    outside the kernels (in bf16 mode of rounded operands, accumulated in
    fp32). ``hs`` is differentiable in ``params``, ``carry0`` and ``xs``;
    ``cT`` is value-only.
    """
    G, T, B, _ = xs.shape
    c0, h0 = carry0
    check_replay_inputs("LSTM", [*params.values(), c0, h0, xs, resets])
    check_resets("LSTM", resets, G, T, B)
    f32 = torch.float32
    weights = (params[k].to(f32) for k in ("wx", "wh", "bh"))
    hs, cT, _ = _lstm_xproj(*weights, c0.to(f32), h0.to(f32), xs.to(f32), resets.to(f32), is_bf16(compute_dtype))
    return hs, cT


def lstm_sequence_x(params: dict, carry0, xs: torch.Tensor, resets: torch.Tensor,
                    compute_dtype=None) -> torch.Tensor:
    """Replay one LSTM over a window through the x-streaming kernels,
    ``xs [T,B,D]`` -> ``hs [T,B,H]``.

    ``params`` holds the packed ``wx``, ``wh``, ``bh``; ``carry0 = (c0, h0)``,
    each ``[B,H]``, enters step 0; ``resets [T,B]`` zeroes the carry before
    step ``t``. ``compute_dtype`` is ``None`` (IEEE fp32) or
    ``torch.bfloat16`` (bf16 matmul operands, fp32 accumulation and state).
    Differentiable in ``params``, ``carry0`` and ``xs``.
    """
    return _lstm_x_streams([params], [carry0], [xs], resets, compute_dtype)[0][0]


def lstm_sequence_with_carry(params: dict, carry0, xs: torch.Tensor, resets: torch.Tensor,
                             compute_dtype=None):
    """One LSTM replay that also returns the carry after the last step,
    ``xs [T,B,D]`` -> ``(hs [T,B,H], (cT, hT))``; arguments as
    :func:`lstm_sequence_x`. The final carry is value-only (detached), for
    truncated-BPTT replay. The x-streaming kernels take up to
    ``X_STREAM_MAX_D`` input columns, the xproj kernels (G=1) wider inputs,
    as the JAX package's ``lstm_sequence`` chooses.
    """
    if xs.shape[-1] <= X_STREAM_MAX_D:
        hs, cT = _lstm_x_streams([params], [carry0], [xs], resets, compute_dtype)
    else:
        one = {k: v[None] for k, v in params.items()}
        hs, cT = lstm_sequence_xproj(one, tuple(c[None] for c in carry0), xs[None], resets[None],
                                     compute_dtype)
    return hs[0], (cT[0], hs[0, -1].detach())


def lstm_sequence_pair(params_pair, carry0_pair, xs_pair, resets: torch.Tensor,
                       compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent LSTM replays with shared resets in one launch per
    kernel; equal to two :func:`lstm_sequence_x` calls. ``carry0_pair`` holds
    each stream's ``(c0, h0)``. Returns ``(hs_a, hs_b)``."""
    hs, _ = _lstm_x_streams(list(params_pair), list(carry0_pair), list(xs_pair), resets, compute_dtype)
    return hs[0], hs[1]
