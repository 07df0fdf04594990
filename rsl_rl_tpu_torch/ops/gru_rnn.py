"""GRU window replay with done-masked resets: CUDA kernels, wrappers, plain version.

Math (flax ``GRUCell``, gates r|z|n, ``h`` zeroed where ``resets[t]`` is set):

    r  = sigmoid(x Wx_r + bx_r + h Wh_r)
    z  = sigmoid(x Wx_z + bx_z + h Wh_z)
    u  = h Wh_n + bhn
    n  = tanh(x Wx_n + bx_n + r * u)
    h' = (1 - z) * n + z * h

Weights use the packed layout of the JAX package's ``_gru_pack``: ``wx
[D,3H]``, ``bx [3H]``, ``wh [H,3H]``, ``bhn [H]``. A leading stream axis runs
independent recurrences.

Two kernel sets, as in the JAX package:

- x-streaming (``csrc/gru_x.cu``), S streams that share the reset mask (S=2:
  the actor and critic memories of a PPO minibatch), the input projection
  inside the kernels. ``gru_x_fwd`` replaces the Pallas
  ``_fwd_kernel_x_pair`` / ``_gru_core_x_pair_fwd_impl`` (S=2) and
  ``_fwd_kernel_x`` / ``_gru_core_x_fwd_impl`` (S=1) of
  ``rsl_rl_tpu/ops/pallas_rnn.py``; ``gru_x_bwd`` and ``gru_x_wgrad`` together
  replace ``_bwd_kernel_x_pair`` / ``_gru_core_x_pair_bwd_impl`` and
  ``_bwd_kernel_x`` / ``_gru_core_x_bwd_impl``.
- xproj-streaming (``csrc/gru_xp.cu``), G streams with a reset mask each, over
  ``xproj = x Wx + bx`` computed outside the kernels in one bulk product per
  stream (a library GEMM, as XLA computes it in the JAX package). ``gru_xp_fwd``
  replaces ``_fwd_kernel`` / ``_gru_core_fwd_impl``; ``gru_xp_bwd`` and
  ``gru_xp_wgrad`` replace ``_bwd_kernel`` / ``_gru_core_bwd_impl``. They serve
  inputs wider than ``X_STREAM_MAX_D`` (G=1) and every replay under
  ``torch.func.vmap``, the seed axis of multi-seed training: the x-streaming
  replay's vmap rule folds the seed and stream axes into G and takes them.

The backward kernels run the reverse-time BPTT chain and write each step's
gate gradients ``dr | dz | dn | du`` to a scratch buffer; the ``*_wgrad``
kernels reduce them into the weight gradients (the split-K reduction of
``csrc/rnn_wgrad.cuh``, which the LSTM replay shares). The xproj backward
needs no ``dx`` product: the gradient of ``xproj`` is the scratch's first 3H
columns.

What bounds them on an H100: the products ``h @ Wh`` (forward and recompute)
and ``dgates @ Whᵀ`` are ``T`` dependent steps of ``[B,H] x [H,3H]`` in IEEE
fp32 on the CUDA cores (no TF32), so the floor is operations at the fp32
non-tensor peak. The TPU kernels keep ``Wh`` resident in VMEM; in fp32 it is
``H*3H*4`` bytes (768 KiB at H=256), more than the 227 KB of shared memory a
block can have. ``gru_x_fwd`` runs the cluster forward of
``csrc/rnn_fwd.cuh``, which it shares with ``lstm_x_fwd``: a cluster of 8
CTAs owns a tile of batch rows for the whole window, each CTA the product
columns ``r | z | n`` of its H/8 hidden columns, whose slice of ``[Wh; Wx]``
stays in its shared memory (bf16 mode: rounded once when staged; streamed
from L2 at every step where it does not fit), and ``h`` goes between the CTAs
through ``hs`` with a cluster barrier a step. The ``n`` column's sums over
``h`` (``u``) and over ``x`` (``a_n``) are kept apart by stashing the first
when the ``x`` rows begin, so no product multiplies a zero block.
``gru_xp_fwd`` runs the same cluster forward over the ``h`` rows alone: its
accumulators start at the stored ``xproj`` row (r, z) and ``bhn`` (u), and
``a_n`` comes straight from ``xproj``. Where its G streams outnumber the
clusters the card runs at once (G=16 against 15), each cluster serves a
whole stream and a share of the sixteenth's rows in one wave, its CTAs
holding both bf16 weight slices. In fp32 mode a 128-row tile costs more
(two fp32 slices do not fit a CTA, so G=16 takes two waves), and the plan
keeps one thread a hidden column (a block a tile of ``BB`` rows of one
stream, re-reading ``Wh`` from L2 at every step) where its step would cost
less than the cluster forward's, by the costs timed on an H100
(``XpFp32Cost``, ``csrc/rnn_fwd.cuh``): G=16 goes to the columns, one
stream (the wide-input path) to the cluster forward.
``gru_x_bwd`` and ``gru_xp_bwd`` take out of the serial chain what does not
depend on the carried gradients, in the three phases of ``csrc/rnn_bwd.cuh``:
the gate quantities ``r | z | a_n | u`` of all steps in one tiled GEMM over
the ``T*B`` rows (skipping the zero blocks of ``[Wh; Wx]`` in that layout;
``gru_xp_bwd``: over all ``G*T*B`` rows, starting at the stored ``xproj``
row and ``bhn`` where ``gru_x_bwd`` multiplies ``x Wx``), then per step one
launch of ``(g*z + [dr|dz|du] @ Whᵀ) * keep`` tiled over the whole card
(each ``Whᵀ`` element read from L2 serves 64 rows) with the cell's gradient
in its epilogue, then ``dx`` for all steps at once (``gru_xp_bwd`` has no
such phase); in bf16 mode their products run on the tensor cores. The weight gradients, which the TPU
accumulates in a scratch carried across its sequential grid, come from a
separate deterministic pass: every block of the reduction owns one output
tile and one split of the ``T*B`` rows and sums them in order into its own
partial tile; a second kernel adds the partials in split order. No atomics,
so the gradients are the same on every run.

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
    merge_streams,
    mm,
    op,
    raise_on,
    shared_resets,
    stream,
    wgrad_scratch,
)
from rsl_rl_tpu_torch.utils.trace import LaunchCounts

#: launches of the x-streaming kernels (``gru_x_*``) and of the xproj kernels (``gru_xp_*``)
launch_counts = LaunchCounts()
xp_launch_counts = LaunchCounts()


# --------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the kernels' reference on the card)
# --------------------------------------------------------------------------


def _gates(xp, wh, bhn, h, bf16):
    """r, z, u, n of one step from its input projection ``xp = x Wx + bx``."""
    H = wh.shape[-2]
    hp = mm(h, wh, bf16)
    r = torch.sigmoid(xp[..., :H] + hp[..., :H])
    z = torch.sigmoid(xp[..., H : 2 * H] + hp[..., H : 2 * H])
    u = hp[..., 2 * H :] + bhn[:, None, :]
    n = torch.tanh(xp[..., 2 * H :] + r * u)
    return r, z, u, n


def input_projection(wx, bx, xs, bf16: bool = False) -> torch.Tensor:
    """``xs [S,T,B,D] @ wx [S,D,3H] + bx [S,3H]`` -> ``[S,T,B,3H]``: one bulk
    product per stream with the replay's operand rounding (differentiable)."""
    S, T, B, D = xs.shape
    xp = torch.baddbmm(bx[:, None, :], op(xs.reshape(S, T * B, D), bf16), op(wx, bf16))
    return xp.reshape(S, T, B, -1)


def gru_xp_plain_fwd(wh, bhn, carry0, xproj, resets, bf16: bool = False) -> torch.Tensor:
    """Plain xproj forward: ``xproj [G,T,B,3H]``, ``resets [G,T,B]`` float,
    ``carry0 [G,B,H]``, ``wh [G,H,3H]``, ``bhn [G,H]`` -> ``hs [G,T,B,H]``."""
    keep = 1.0 - resets
    h = carry0
    hs = []
    for t in range(xproj.shape[1]):
        h = h * keep[:, t, :, None]
        r, z, u, n = _gates(xproj[:, t], wh, bhn, h, bf16)
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def gru_xp_plain_bwd(wh, bhn, carry0, xproj, resets, hs, ghs, bf16: bool = False):
    """Plain reverse-time BPTT chain of :func:`gru_xp_plain_fwd` for the output
    gradient ``ghs`` (the plain version of ``gru_xp_bwd``).

    Returns ``(dcarry0, gscratch)`` with ``gscratch [G,T,B,4H]`` holding each
    step's ``dr | dz | dn | du``; its first 3H columns are the gradient of
    ``xproj``. In the phases of ``gru_x_bwd``: the gates of every step at
    once, recomputed from ``hs[t-1]`` (``carry0`` at t=0) with the forward's
    operand rounding; then the chain, whose only product is ``[dr|dz|du] @
    Whᵀ``.
    """
    G, T, B, _ = xproj.shape
    H = carry0.shape[-1]
    keep = (1.0 - resets)[..., None]
    h_prev = torch.cat([carry0[:, None], hs[:, :-1]], dim=1) * keep
    r, z, u, n = _gates(xproj.reshape(G, T * B, 3 * H), wh, bhn, h_prev.reshape(G, T * B, H), bf16)
    r, z, u, n = (v.reshape(G, T, B, H) for v in (r, z, u, n))
    gscratch = torch.empty((G, T, B, 4 * H), dtype=xproj.dtype, device=xproj.device)
    dh = torch.zeros_like(carry0)
    for t in reversed(range(T)):
        g = ghs[:, t] + dh
        dz = g * (h_prev[:, t] - n[:, t]) * z[:, t] * (1.0 - z[:, t])
        dn = g * (1.0 - z[:, t]) * (1.0 - n[:, t] * n[:, t])
        du = dn * r[:, t]
        dr = dn * u[:, t] * r[:, t] * (1.0 - r[:, t])
        gscratch[:, t] = torch.cat([dr, dz, dn, du], dim=-1)
        dgates = torch.cat([dr, dz, du], dim=-1)
        dh = (g * z[:, t] + mm(dgates, wh.transpose(-1, -2), bf16)) * keep[:, t]
    return dh, gscratch


def gru_xp_plain_wgrad(resets, carry0, hs, gscratch, bf16: bool = False):
    """Plain weight-gradient reduction (the plain version of ``gru_xp_wgrad``):
    sums over all ``T*B`` rows of ``h_maskedᵀ [dr|dz|du]`` and ``du``.
    Returns ``(dwh, dbhn)``."""
    G, T, B = resets.shape
    H = carry0.shape[-1]
    h_prev = torch.cat([carry0[:, None], hs[:, :-1]], dim=1) * (1.0 - resets)[..., None]
    gs = gscratch.reshape(G, T * B, 4 * H)
    dgates = torch.cat([gs[..., : 2 * H], gs[..., 3 * H :]], dim=-1)
    return mm(h_prev.reshape(G, T * B, H).transpose(-1, -2), dgates, bf16), gs[..., 3 * H :].sum(dim=1)


def gru_x_plain_fwd(wx, bx, wh, bhn, carry0, xs, resets, bf16: bool = False) -> torch.Tensor:
    """Plain forward: ``xs [S,T,B,D]``, ``resets [T,B]`` float, ``carry0
    [S,B,H]``, ``wx [S,D,3H]``, ``bx [S,3H]``, ``wh [S,H,3H]``, ``bhn [S,H]``
    -> ``hs [S,T,B,H]``."""
    xproj = input_projection(wx, bx, xs, bf16)
    return gru_xp_plain_fwd(wh, bhn, carry0, xproj, shared_resets(resets, xs.shape[0]), bf16)


def gru_x_plain_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, bf16: bool = False):
    """Plain reverse-time BPTT chain of :func:`gru_x_plain_fwd` for the output
    gradient ``ghs`` (the plain version of ``gru_x_bwd``).

    Returns ``(dx, dcarry0, gscratch)`` with ``gscratch [S,T,B,4H]`` holding
    each step's ``dr | dz | dn | du``, and ``dx = [dr|dz|dn] Wxᵀ``, the third
    phase, over all steps at once.
    """
    H = carry0.shape[-1]
    xproj = input_projection(wx, bx, xs, bf16)
    dcarry0, gscratch = gru_xp_plain_bwd(wh, bhn, carry0, xproj, shared_resets(resets, xs.shape[0]),
                                         hs, ghs, bf16)
    dx = mm(gscratch[..., : 3 * H], wx.transpose(-1, -2)[:, None], bf16)
    return dx, dcarry0, gscratch


def gru_x_plain_wgrad(xs, resets, carry0, hs, gscratch, bf16: bool = False):
    """Plain weight-gradient reduction (the plain version of ``gru_x_wgrad``):
    sums over all ``T*B`` rows of ``h_maskedᵀ [dr|dz|du]``, ``xᵀ [dr|dz|dn]``,
    ``[dr|dz|dn]`` and ``du``. Returns ``(dwx, dbx, dwh, dbhn)``."""
    S, T, B, D = xs.shape
    H = carry0.shape[-1]
    dwh, dbhn = gru_xp_plain_wgrad(shared_resets(resets, S), carry0, hs, gscratch, bf16)
    dxproj = gscratch.reshape(S, T * B, 4 * H)[..., : 3 * H]
    dwx = mm(xs.reshape(S, T * B, D).transpose(-1, -2), dxproj, bf16)
    return dwx, dxproj.sum(dim=1), dwh, dbhn


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gru_x": {
        "gru_x_fwd": [_P] * 8 + [_I] * 6 + [_P],
        "gru_x_bwd": [_P] * 13 + [_I] * 6 + [_P] * 2,
        "gru_x_fwd_plan": [_I] * 5 + [_P],
        "gru_x_wgrad": [_P] * 7 + [_I] * 7 + [_P],
    },
    "gru_xp": {
        "gru_xp_fwd": [_P] * 6 + [_I] * 5 + [_P],
        "gru_xp_fwd_plan": [_I] * 4 + [_P],
        "gru_xp_bwd": [_P] * 10 + [_I] * 5 + [_P] * 2,
        "gru_xp_wgrad": [_P] * 6 + [_I] * 6 + [_P],
    },
}
_LIBS: dict[str, ctypes.CDLL] = {}


def _lib(name: str = "gru_x") -> ctypes.CDLL:
    if name not in _LIBS:
        _LIBS[name] = load_kernels(name, _SIGNATURES[name])
    return _LIBS[name]


def _dims(wx, xs):
    S, T, B, D = xs.shape
    H = wx.shape[-1] // 3
    check_hidden("GRU", H)
    return S, T, B, D, H


def gru_x_fwd(wx, bx, wh, bhn, carry0, xs, resets, bf16: bool = False) -> torch.Tensor:
    """Launch the forward kernel; shapes as :func:`gru_x_plain_fwd`."""
    S, T, B, D, H = _dims(wx, xs)
    ptrs = [
        check("xs", xs, (S, T, B, D)),
        check("resets", resets, (T, B)),
        check("carry0", carry0, (S, B, H)),
        check("wx", wx, (S, D, 3 * H)),
        check("bx", bx, (S, 3 * H)),
        check("wh", wh, (S, H, 3 * H)),
        check("bhn", bhn, (S, H)),
    ]
    hs = torch.empty((S, T, B, H), dtype=torch.float32, device=xs.device)
    raise_on("gru_x_fwd", _lib().gru_x_fwd(*ptrs, hs.data_ptr(), S, T, B, D, H, int(bf16), stream()))
    launch_counts.fwd_launches += 1
    return hs


def gru_x_fwd_plan(S: int, B: int, D: int, H: int, bf16: bool = False) -> dict:
    """The grid :func:`gru_x_fwd` chooses on the current card for these
    shapes: the clusters the card runs at once, the batch rows of a cluster,
    the clusters launched, whether the weight slices stay in shared memory,
    the rows of the tiles that take a cluster's rows past its full 128-row
    tiles (96 or 160: one tile takes them all), the CTAs of a cluster and the
    waves."""
    check_hidden("GRU", H)
    return fwd_plan("gru_x_fwd_plan", _lib().gru_x_fwd_plan, S, B, D, H, int(bf16))


def _gru_x_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, bf16, phase_ms):
    S, T, B, D, H = _dims(wx, xs)
    whT = wh.transpose(-1, -2).contiguous()  # [S,3H,H]: coalesced dgates @ Whᵀ
    ptrs = [
        check("xs", xs, (S, T, B, D)),
        check("resets", resets, (T, B)),
        check("carry0", carry0, (S, B, H)),
        check("wx", wx, (S, D, 3 * H)),
        check("bx", bx, (S, 3 * H)),
        check("wh", wh, (S, H, 3 * H)),
        check("whT", whT, (S, 3 * H, H)),
        check("bhn", bhn, (S, H)),
        check("hs", hs, (S, T, B, H)),
        check("ghs", ghs, (S, T, B, H)),
    ]
    dx = torch.empty_like(xs)
    dcarry0 = torch.empty_like(carry0)
    gscratch = torch.empty((S, T, B, 4 * H), dtype=torch.float32, device=xs.device)
    out = [dx.data_ptr(), dcarry0.data_ptr(), gscratch.data_ptr()]
    raise_on("gru_x_bwd", _lib().gru_x_bwd(*ptrs, *out, S, T, B, D, H, int(bf16), stream(), phase_ms))
    launch_counts.bwd_launches += 1
    return dx, dcarry0, gscratch


def gru_x_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, bf16: bool = False):
    """Launch the reverse-time BPTT kernels (the three phases of
    ``csrc/rnn_bwd.cuh``).

    Returns ``(dx, dcarry0, gscratch)``; ``gscratch [S,T,B,4H]`` holds each
    step's ``dr | dz | dn | du`` rows for :func:`gru_x_wgrad`.
    """
    return _gru_x_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, bf16, None)


def gru_x_bwd_phase_ms(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, bf16: bool = False):
    """One :func:`gru_x_bwd` call timed by CUDA events between its phases
    (waits for the stream): ``(gates ms, chain ms, dx ms)``."""
    ms = (ctypes.c_float * 3)()
    _gru_x_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, bf16, ctypes.addressof(ms))
    return tuple(ms)


def gru_wgrad_dropped(H: int, D: int):
    """The blocks of the reduction's ``C [., H+D+1, 4H]`` that the GRU drops,
    as ``(rows, columns)`` slices: h rows x dn (the gradient of ``h Wh_n``
    flows through du) and x rows x du (``u`` has no x term). The kernel does
    not compute them and writes zeros there; :func:`gru_wgrad_outputs` never
    reads them."""
    return [(slice(0, H), slice(2 * H, 3 * H)), (slice(H, H + D), slice(3 * H, 4 * H))]


def gru_wgrad_outputs(C: torch.Tensor, H: int, D: int):
    """``(dwx, dbx, dwh, dbhn)`` from the reduction's ``C [S, H+D+1, 4H] =
    Σ [h_masked | x | 1]ᵀ [dr | dz | dn | du]`` (D = 0 for the xproj one)."""
    dwh = torch.cat([C[:, :H, : 2 * H], C[:, :H, 3 * H :]], dim=-1)
    dwx = C[:, H : H + D, : 3 * H].contiguous()
    dbx = C[:, H + D, : 3 * H].contiguous()
    dbhn = C[:, H + D, 3 * H :].contiguous()
    return dwx, dbx, dwh, dbhn


def gru_x_wgrad(xs, resets, carry0, hs, gscratch, bf16: bool = False):
    """Launch the weight-gradient reduction; returns ``(dwx, dbx, dwh, dbhn)``.

    The kernel computes ``C = Σ_rows [h_masked | x | 1]ᵀ · [dr | dz | dn | du]``
    over the ``T*B`` rows, ``C [S, H+D+1, 4H]``, but the blocks of
    :func:`gru_wgrad_dropped`; the gradients are slices of it.
    """
    S, T, B, D = xs.shape
    H = carry0.shape[-1]
    check_hidden("GRU", H)
    ptrs = [
        check("xs", xs, (S, T, B, D)),
        check("resets", resets, (T, B)),
        check("carry0", carry0, (S, B, H)),
        check("hs", hs, (S, T, B, H)),
        check("gscratch", gscratch, (S, T, B, 4 * H)),
    ]
    P, W, C = wgrad_scratch(S, T, B, D, H, xs.device, bf16)
    raise_on("gru_x_wgrad", _lib().gru_x_wgrad(*ptrs, W.data_ptr(), C.data_ptr(), S, T, B, D, H, P,
                                                int(bf16), stream()))
    launch_counts.wgrad_launches += 1
    return gru_wgrad_outputs(C, H, D)


def _xp_dims(wh, xproj):
    G, T, B, _ = xproj.shape
    H = wh.shape[-2]
    check_hidden("GRU", H)
    return G, T, B, H


def gru_xp_fwd(wh, bhn, carry0, xproj, resets, bf16: bool = False) -> torch.Tensor:
    """Launch the xproj forward kernel (the cluster forward of
    ``csrc/rnn_fwd.cuh``, or one thread a hidden column where
    :func:`gru_xp_fwd_plan` says so); shapes as :func:`gru_xp_plain_fwd`."""
    G, T, B, H = _xp_dims(wh, xproj)
    ptrs = [
        check("xproj", xproj, (G, T, B, 3 * H)),
        check("resets", resets, (G, T, B)),
        check("carry0", carry0, (G, B, H)),
        check("wh", wh, (G, H, 3 * H)),
        check("bhn", bhn, (G, H)),
    ]
    hs = torch.empty((G, T, B, H), dtype=torch.float32, device=xproj.device)
    raise_on("gru_xp_fwd", _lib("gru_xp").gru_xp_fwd(*ptrs, hs.data_ptr(), G, T, B, H, int(bf16), stream()))
    xp_launch_counts.fwd_launches += 1
    return hs


def gru_xp_fwd_plan(G: int, B: int, H: int, bf16: bool = False) -> dict:
    """The grid :func:`gru_xp_fwd` chooses on the current card for G streams
    of B rows: the cluster forward's (``"kernel": "cluster"``, keys as
    :func:`gru_x_fwd_plan`; ``parts``: the streams a cluster serves at most),
    or ``{"kernel": "columns"}`` (fp32 mode where one thread a column costs
    less, or the weight slices would stream from L2)."""
    check_hidden("GRU", H)
    return fwd_plan("gru_xp_fwd_plan", _lib("gru_xp").gru_xp_fwd_plan, G, B, H, int(bf16))


def _gru_xp_bwd(wh, bhn, carry0, xproj, resets, hs, ghs, bf16, phase_ms):
    G, T, B, H = _xp_dims(wh, xproj)
    whT = wh.transpose(-1, -2).contiguous()  # [G,3H,H]: coalesced dgates @ Whᵀ
    ptrs = [
        check("xproj", xproj, (G, T, B, 3 * H)),
        check("resets", resets, (G, T, B)),
        check("carry0", carry0, (G, B, H)),
        check("wh", wh, (G, H, 3 * H)),
        check("whT", whT, (G, 3 * H, H)),
        check("bhn", bhn, (G, H)),
        check("hs", hs, (G, T, B, H)),
        check("ghs", ghs, (G, T, B, H)),
    ]
    dcarry0 = torch.empty_like(carry0)
    gscratch = torch.empty((G, T, B, 4 * H), dtype=torch.float32, device=xproj.device)
    raise_on("gru_xp_bwd", _lib("gru_xp").gru_xp_bwd(*ptrs, dcarry0.data_ptr(), gscratch.data_ptr(),
                                                      G, T, B, H, int(bf16), stream(), phase_ms))
    xp_launch_counts.bwd_launches += 1
    return dcarry0, gscratch


def gru_xp_bwd(wh, bhn, carry0, xproj, resets, hs, ghs, bf16: bool = False):
    """Launch the xproj BPTT kernels (the gates and chain phases of
    ``csrc/rnn_bwd.cuh``); returns ``(dcarry0, gscratch)`` as
    :func:`gru_xp_plain_bwd`."""
    return _gru_xp_bwd(wh, bhn, carry0, xproj, resets, hs, ghs, bf16, None)


def gru_xp_bwd_phase_ms(wh, bhn, carry0, xproj, resets, hs, ghs, bf16: bool = False):
    """One :func:`gru_xp_bwd` call timed by CUDA events between its phases
    (waits for the stream): ``(gates ms, chain ms, 0.0)``; the xproj backward
    has no dx phase."""
    ms = (ctypes.c_float * 3)()
    _gru_xp_bwd(wh, bhn, carry0, xproj, resets, hs, ghs, bf16, ctypes.addressof(ms))
    return tuple(ms)


def gru_xp_wgrad(resets, carry0, hs, gscratch, bf16: bool = False):
    """Launch the xproj weight-gradient reduction; returns ``(dwh, dbhn)``.

    The kernel computes ``C = Σ_rows [h_masked | 1]ᵀ · [dr | dz | dn | du]``
    over the ``T*B`` rows, ``C [G, H+1, 4H]``; the gradients are slices of it.
    """
    G, T, B = resets.shape
    H = carry0.shape[-1]
    check_hidden("GRU", H)
    ptrs = [
        check("resets", resets, (G, T, B)),
        check("carry0", carry0, (G, B, H)),
        check("hs", hs, (G, T, B, H)),
        check("gscratch", gscratch, (G, T, B, 4 * H)),
    ]
    P, W, C = wgrad_scratch(G, T, B, 0, H, hs.device, bf16)
    raise_on("gru_xp_wgrad", _lib("gru_xp").gru_xp_wgrad(*ptrs, W.data_ptr(), C.data_ptr(), G, T, B, H, P,
                                                          int(bf16), stream()))
    xp_launch_counts.wgrad_launches += 1
    return gru_wgrad_outputs(C, H, 0)[2:]


# --------------------------------------------------------------------------
# autograd and public API
# --------------------------------------------------------------------------


class _GruXp(torch.autograd.Function):
    """``hs`` of G xproj replays; differentiable in ``wh``, ``bhn``,
    ``carry0`` and ``xproj`` (the JAX package's ``_gru_core``)."""

    @staticmethod
    def forward(wh, bhn, carry0, xproj, resets, bf16):
        fwd = gru_xp_fwd if xproj.is_cuda else gru_xp_plain_fwd
        return fwd(wh, bhn, carry0, xproj, resets, bf16)

    @staticmethod
    def setup_context(ctx, inputs, output):
        wh, bhn, carry0, xproj, resets, bf16 = inputs
        ctx.save_for_backward(wh, bhn, carry0, xproj, resets, output)
        ctx.bf16 = bf16

    @staticmethod
    def backward(ctx, ghs):
        wh, bhn, carry0, xproj, resets, hs = ctx.saved_tensors
        ghs = ghs.contiguous()
        if xproj.is_cuda:
            dcarry0, gscratch = gru_xp_bwd(wh, bhn, carry0, xproj, resets, hs, ghs, ctx.bf16)
            dwh, dbhn = gru_xp_wgrad(resets, carry0, hs, gscratch, ctx.bf16)
        else:
            dcarry0, gscratch = gru_xp_plain_bwd(wh, bhn, carry0, xproj, resets, hs, ghs, ctx.bf16)
            dwh, dbhn = gru_xp_plain_wgrad(resets, carry0, hs, gscratch, ctx.bf16)
        return dwh, dbhn, dcarry0, gscratch[..., : 3 * wh.shape[-2]], None, None

    @staticmethod
    def vmap(info, in_dims, wh, bhn, carry0, xproj, resets, bf16):
        """A vmapped axis V folds into the stream axis: one launch of V*G streams."""
        args = [merge_streams(batch_first(t, d, info.batch_size))
                for t, d in zip((wh, bhn, carry0, xproj, resets), in_dims)]
        hs = _GruXp.apply(*args, bf16)
        return hs.reshape(info.batch_size, -1, *hs.shape[1:]), 0


def _gru_xproj(wx, bx, wh, bhn, carry0, xs, resets, bf16):
    """G xproj replays (fp32 tensors with a leading stream axis): the input
    projections in one bulk product, then the xproj kernels."""
    xproj = input_projection(wx, bx, xs, bf16)
    return _GruXp.apply(wh.contiguous(), bhn.contiguous(), carry0.contiguous(), xproj,
                        resets.contiguous(), bf16)


class _GruX(torch.autograd.Function):
    """``hs`` of S x-streaming replays that share the reset mask."""

    @staticmethod
    def forward(wx, bx, wh, bhn, carry0, xs, resets, bf16):
        fwd = gru_x_fwd if xs.is_cuda else gru_x_plain_fwd
        return fwd(wx, bx, wh, bhn, carry0, xs, resets, bf16)

    @staticmethod
    def setup_context(ctx, inputs, output):
        wx, bx, wh, bhn, carry0, xs, resets, bf16 = inputs
        ctx.save_for_backward(wx, bx, wh, bhn, carry0, xs, resets, output)
        ctx.bf16 = bf16

    @staticmethod
    def backward(ctx, ghs):
        wx, bx, wh, bhn, carry0, xs, resets, hs = ctx.saved_tensors
        ghs = ghs.contiguous()
        if xs.is_cuda:
            dx, dcarry0, gscratch = gru_x_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, ctx.bf16)
            dwx, dbx, dwh, dbhn = gru_x_wgrad(xs, resets, carry0, hs, gscratch, ctx.bf16)
        else:
            dx, dcarry0, gscratch = gru_x_plain_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, ctx.bf16)
            dwx, dbx, dwh, dbhn = gru_x_plain_wgrad(xs, resets, carry0, hs, gscratch, ctx.bf16)
        return dwx, dbx, dwh, dbhn, dcarry0, dx, None, None

    @staticmethod
    def vmap(info, in_dims, wx, bx, wh, bhn, carry0, xs, resets, bf16):
        """Under ``torch.func.vmap`` (the seed axis of multi-seed training) the
        replay takes the xproj kernels, as the JAX package's replay does under
        ``jax.vmap``: the vmapped axis V and the stream axis S fold into the
        xproj kernels' stream axis, V*S streams with a reset mask each."""
        V = info.batch_size
        wx, bx, wh, bhn, carry0, xs, resets = (
            batch_first(t, d, V) for t, d in zip((wx, bx, wh, bhn, carry0, xs, resets), in_dims))
        S = xs.shape[1]
        resets = resets[:, None].expand(V, S, *resets.shape[1:])
        hs = _gru_xproj(*(merge_streams(t) for t in (wx, bx, wh, bhn, carry0, xs, resets)), bf16)
        return hs.reshape(V, S, *hs.shape[1:]), 0


def _gru_x_streams(params_list, carry0_list, xs_list, resets, compute_dtype):
    T, B, _ = xs_list[0].shape
    check_replay_inputs("GRU", [t for p in params_list for t in p.values()] + [*carry0_list, *xs_list, resets])
    f32 = torch.float32
    wx = torch.stack([p["wx"] for p in params_list]).to(f32)
    bx = torch.stack([p["bx"] for p in params_list]).to(f32)
    wh = torch.stack([p["wh"] for p in params_list]).to(f32)
    bhn = torch.stack([p["bhn"] for p in params_list]).to(f32)
    carry0 = torch.stack(list(carry0_list)).to(f32)
    xs = torch.stack(list(xs_list)).to(f32)
    resets = resets.to(f32).reshape(T, B).contiguous()
    return _GruX.apply(wx, bx, wh, bhn, carry0, xs, resets, is_bf16(compute_dtype))


def gru_step(params: dict, h: torch.Tensor, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """One GRU step, ``h [N,H]``, ``x [N,D]`` -> ``h' [N,H]``, with the same
    math and operand rounding as the replay, so acting and replay agree.
    Plain PyTorch on every device: acting runs one step at a time."""
    bf16 = is_bf16(compute_dtype)
    xp = mm(x[None], params["wx"][None], bf16) + params["bx"][None, None]
    r, z, u, n = _gates(xp, params["wh"][None], params["bhn"][None], h[None], bf16)
    return ((1.0 - z) * n + z * h[None])[0]


def gru_sequence_x(params: dict, carry0: torch.Tensor, xs: torch.Tensor, resets: torch.Tensor,
                   compute_dtype=None) -> torch.Tensor:
    """Replay one GRU over a window through the x-streaming kernels,
    ``xs [T,B,D]`` -> ``hs [T,B,H]``.

    ``params`` holds the packed ``wx``, ``bx``, ``wh``, ``bhn``; ``carry0 [B,H]``
    enters step 0; ``resets [T,B]`` zeroes the carry before step ``t``.
    ``compute_dtype`` is ``None`` (IEEE fp32) or ``torch.bfloat16`` (bf16
    matmul operands, fp32 accumulation and state). Differentiable in
    ``params``, ``carry0`` and ``xs``.
    """
    return _gru_x_streams([params], [carry0], [xs], resets, compute_dtype)[0]


def gru_sequence_xproj(params: dict, carry0: torch.Tensor, xs: torch.Tensor, resets: torch.Tensor,
                       compute_dtype=None) -> torch.Tensor:
    """G independent GRU replays through the xproj kernels, ``xs [G,T,B,D]``
    -> ``hs [G,T,B,H]``.

    ``params`` holds the packed weights with a leading ``[G]`` axis,
    ``carry0 [G,B,H]``, ``resets [G,T,B]`` (each stream its own mask). The
    input projection is one bulk product per stream outside the kernels (in
    bf16 mode of rounded operands, accumulated in fp32). Differentiable in
    ``params``, ``carry0`` and ``xs``.
    """
    G, T, B, _ = xs.shape
    check_replay_inputs("GRU", [*params.values(), carry0, xs, resets])
    check_resets("GRU", resets, G, T, B)
    f32 = torch.float32
    weights = (params[k].to(f32) for k in ("wx", "bx", "wh", "bhn"))
    return _gru_xproj(*weights, carry0.to(f32), xs.to(f32), resets.to(f32), is_bf16(compute_dtype))


def gru_sequence(params: dict, carry0: torch.Tensor, xs: torch.Tensor, resets: torch.Tensor,
                 compute_dtype=None) -> torch.Tensor:
    """One GRU replay, ``xs [T,B,D]`` -> ``hs [T,B,H]``: the x-streaming
    kernels up to ``X_STREAM_MAX_D`` input columns, the xproj kernels (G=1)
    beyond, as the JAX package's ``gru_sequence`` chooses."""
    if xs.shape[-1] <= X_STREAM_MAX_D:
        return gru_sequence_x(params, carry0, xs, resets, compute_dtype)
    one = {k: v[None] for k, v in params.items()}
    return gru_sequence_xproj(one, carry0[None], xs[None], resets[None], compute_dtype)[0]


def gru_sequence_pair(params_pair, carry0_pair, xs_pair, resets: torch.Tensor,
                      compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent GRU replays with shared resets in one launch per
    kernel; equal to two :func:`gru_sequence_x` calls. Returns ``(hs_a, hs_b)``."""
    hs = _gru_x_streams(list(params_pair), list(carry0_pair), list(xs_pair), resets, compute_dtype)
    return hs[0], hs[1]
