"""GRU window replay with done-masked resets: CUDA kernels, wrappers, plain version.

Math (flax ``GRUCell``, gates r|z|n, ``h`` zeroed where ``resets[t]`` is set):

    r  = sigmoid(x Wx_r + bx_r + h Wh_r)
    z  = sigmoid(x Wx_z + bx_z + h Wh_z)
    u  = h Wh_n + bhn
    n  = tanh(x Wx_n + bx_n + r * u)
    h' = (1 - z) * n + z * h

Weights use the packed layout of the JAX package's ``_gru_pack``: ``wx
[D,3H]``, ``bx [3H]``, ``wh [H,3H]``, ``bhn [H]``. A leading stream axis S
runs independent recurrences (S=2: the actor and critic memories of a PPO
minibatch) that share the reset mask.

Kernels (``csrc/gru_x.cu``), one CUDA launch each:

- ``gru_x_fwd`` replaces the Pallas ``_fwd_kernel_x_pair`` /
  ``_gru_core_x_pair_fwd_impl`` (S=2) and ``_fwd_kernel_x`` /
  ``_gru_core_x_fwd_impl`` (S=1) of ``rsl_rl_tpu/ops/pallas_rnn.py``.
- ``gru_x_bwd`` and ``gru_x_wgrad`` together replace ``_bwd_kernel_x_pair`` /
  ``_gru_core_x_pair_bwd_impl`` and ``_bwd_kernel_x`` / ``_gru_core_x_bwd_impl``.
  ``gru_x_bwd`` runs the reverse-time BPTT chain and writes each step's gate
  gradients to a scratch buffer; ``gru_x_wgrad`` reduces them into the weight
  gradients (the split-K reduction of ``csrc/rnn_wgrad.cuh``, which the LSTM
  replay shares).

What bounds them on an H100: the products ``h @ Wh`` (forward and recompute)
and ``dgates @ Whᵀ`` are ``T`` dependent steps of ``[B,H] x [H,3H]`` in IEEE
fp32 on the CUDA cores (no TF32), so the floor is operations at the fp32
non-tensor peak. The TPU kernels keep ``Wh`` resident in VMEM; in fp32 it is
``H*3H*4`` bytes (768 KiB at H=256), more than the 227 KB of shared memory a
block can have. So each block owns a tile of ``BB`` batch rows of one stream,
keeps its hidden tile in shared memory and its own hidden column in
registers, and re-reads ``Wh`` from L2 (50 MB, where all blocks share one
copy) at every step. The weight gradients, which the TPU accumulates in a
scratch carried across its sequential grid, come from a separate
deterministic pass: every block of ``gru_x_wgrad`` owns one output tile and
one split of the ``T*B`` rows and sums them in order into its own partial
tile; a second kernel adds the partials in split order. No atomics, so the
gradients are the same on every run.

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


def _gates(wx, bx, wh, bhn, h, x, bf16):
    H = wh.shape[-2]
    xp = mm(x, wx, bf16) + bx[:, None, :]
    hp = mm(h, wh, bf16)
    r = torch.sigmoid(xp[..., :H] + hp[..., :H])
    z = torch.sigmoid(xp[..., H : 2 * H] + hp[..., H : 2 * H])
    u = hp[..., 2 * H :] + bhn[:, None, :]
    n = torch.tanh(xp[..., 2 * H :] + r * u)
    return r, z, u, n


def gru_x_plain_fwd(wx, bx, wh, bhn, carry0, xs, resets, bf16: bool = False) -> torch.Tensor:
    """Plain forward: ``xs [S,T,B,D]``, ``resets [T,B]`` float, ``carry0
    [S,B,H]``, ``wx [S,D,3H]``, ``bx [S,3H]``, ``wh [S,H,3H]``, ``bhn [S,H]``
    -> ``hs [S,T,B,H]``."""
    keep = 1.0 - resets
    h = carry0
    hs = []
    for t in range(xs.shape[1]):
        h = h * keep[t][None, :, None]
        r, z, u, n = _gates(wx, bx, wh, bhn, h, xs[:, t], bf16)
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def gru_x_plain_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, bf16: bool = False):
    """Plain reverse-time BPTT chain of :func:`gru_x_plain_fwd` for the output
    gradient ``ghs`` (the plain version of ``gru_x_bwd``).

    Returns ``(dx, dcarry0, gscratch)`` with ``gscratch [S,T,B,4H]`` holding
    each step's ``dr | dz | dn | du``. Gate activations are recomputed from
    ``hs[t-1]`` (``carry0`` at t=0) with the forward's operand rounding.
    """
    S, T, B, _ = xs.shape
    H = carry0.shape[-1]
    keep = 1.0 - resets
    dx = torch.empty_like(xs)
    gscratch = torch.empty((S, T, B, 4 * H), dtype=xs.dtype, device=xs.device)
    dh = torch.zeros_like(carry0)
    for t in reversed(range(T)):
        k = keep[t][None, :, None]
        h = (carry0 if t == 0 else hs[:, t - 1]) * k
        r, z, u, n = _gates(wx, bx, wh, bhn, h, xs[:, t], bf16)
        g = ghs[:, t] + dh
        dz = g * (h - n) * z * (1.0 - z)
        dn = g * (1.0 - z) * (1.0 - n * n)
        du = dn * r
        dr = dn * u * r * (1.0 - r)
        gscratch[:, t] = torch.cat([dr, dz, dn, du], dim=-1)
        dx[:, t] = mm(torch.cat([dr, dz, dn], dim=-1), wx.transpose(-1, -2), bf16)
        dgates = torch.cat([dr, dz, du], dim=-1)
        dh = (g * z + mm(dgates, wh.transpose(-1, -2), bf16)) * k
    return dx, dh, gscratch


def gru_x_plain_wgrad(xs, resets, carry0, hs, gscratch, bf16: bool = False):
    """Plain weight-gradient reduction (the plain version of ``gru_x_wgrad``):
    sums over all ``T*B`` rows of ``h_maskedᵀ [dr|dz|du]``, ``xᵀ [dr|dz|dn]``,
    ``[dr|dz|dn]`` and ``du``. Returns ``(dwx, dbx, dwh, dbhn)``."""
    S, T, B, D = xs.shape
    H = carry0.shape[-1]
    h_prev = torch.cat([carry0[:, None], hs[:, :-1]], dim=1) * (1.0 - resets)[None, :, :, None]
    G = gscratch.reshape(S, T * B, 4 * H)
    dxproj = G[..., : 3 * H]
    dgates = torch.cat([G[..., : 2 * H], G[..., 3 * H :]], dim=-1)
    dwh = mm(h_prev.reshape(S, T * B, H).transpose(-1, -2), dgates, bf16)
    dwx = mm(xs.reshape(S, T * B, D).transpose(-1, -2), dxproj, bf16)
    return dwx, dxproj.sum(dim=1), dwh, G[..., 3 * H :].sum(dim=1)


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gru_x_fwd": [_P] * 8 + [_I] * 6 + [_P],
    "gru_x_bwd": [_P] * 13 + [_I] * 6 + [_P],
    "gru_x_wgrad": [_P] * 7 + [_I] * 7 + [_P],
}
_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = load_kernels("gru_x", _SIGNATURES)
    return _LIB


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


def gru_x_bwd(wx, bx, wh, bhn, carry0, xs, resets, hs, ghs, bf16: bool = False):
    """Launch the reverse-time BPTT kernel.

    Returns ``(dx, dcarry0, gscratch)``; ``gscratch [S,T,B,4H]`` holds each
    step's ``dr | dz | dn | du`` rows for :func:`gru_x_wgrad`.
    """
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
    raise_on("gru_x_bwd", _lib().gru_x_bwd(*ptrs, *out, S, T, B, D, H, int(bf16), stream()))
    launch_counts.bwd_launches += 1
    return dx, dcarry0, gscratch


def gru_x_wgrad(xs, resets, carry0, hs, gscratch, bf16: bool = False):
    """Launch the weight-gradient reduction; returns ``(dwx, dbx, dwh, dbhn)``.

    The kernel computes ``C = Σ_rows [h_masked | x | 1]ᵀ · [dr | dz | dn | du]``
    over the ``T*B`` rows, ``C [S, H+D+1, 4H]``; the gradients are slices of it.
    """
    S, T, B, D = xs.shape
    H = carry0.shape[-1]
    ptrs = [
        check("xs", xs, (S, T, B, D)),
        check("resets", resets, (T, B)),
        check("carry0", carry0, (S, B, H)),
        check("hs", hs, (S, T, B, H)),
        check("gscratch", gscratch, (S, T, B, 4 * H)),
    ]
    P = wgrad_splits(T * B)
    W = torch.empty((S, P, H + D + 1, 4 * H), dtype=torch.float32, device=xs.device)
    C = torch.empty((S, H + D + 1, 4 * H), dtype=torch.float32, device=xs.device)
    raise_on("gru_x_wgrad", _lib().gru_x_wgrad(*ptrs, W.data_ptr(), C.data_ptr(), S, T, B, D, H, P,
                                                int(bf16), stream()))
    launch_counts.wgrad_launches += 1
    dwh = torch.cat([C[:, :H, : 2 * H], C[:, :H, 3 * H :]], dim=-1)
    dwx = C[:, H : H + D, : 3 * H].contiguous()
    dbx = C[:, H + D, : 3 * H].contiguous()
    dbhn = C[:, H + D, 3 * H :].contiguous()
    return dwx, dbx, dwh, dbhn


# --------------------------------------------------------------------------
# autograd and public API
# --------------------------------------------------------------------------


class _GruX(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wx, bx, wh, bhn, carry0, xs, resets, bf16):
        if xs.is_cuda:
            hs = gru_x_fwd(wx, bx, wh, bhn, carry0, xs, resets, bf16)
        else:
            hs = gru_x_plain_fwd(wx, bx, wh, bhn, carry0, xs, resets, bf16)
        ctx.save_for_backward(wx, bx, wh, bhn, carry0, xs, resets, hs)
        ctx.bf16 = bf16
        return hs

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


def _gru_x_streams(params_list, carry0_list, xs_list, resets, compute_dtype):
    T, B, D = xs_list[0].shape
    tensors = [t for p in params_list for t in p.values()] + [*carry0_list, *xs_list, resets]
    check_replay_inputs("GRU", tensors, D, xs_list[0].is_cuda)
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
    r, z, u, n = _gates(
        params["wx"][None], params["bx"][None], params["wh"][None], params["bhn"][None],
        h[None], x[None], bf16,
    )
    return ((1.0 - z) * n + z * h[None])[0]


def gru_sequence_x(params: dict, carry0: torch.Tensor, xs: torch.Tensor, resets: torch.Tensor,
                   compute_dtype=None) -> torch.Tensor:
    """Replay one GRU over a window, ``xs [T,B,D]`` -> ``hs [T,B,H]``.

    ``params`` holds the packed ``wx``, ``bx``, ``wh``, ``bhn``; ``carry0 [B,H]``
    enters step 0; ``resets [T,B]`` zeroes the carry before step ``t``.
    ``compute_dtype`` is ``None`` (IEEE fp32) or ``torch.bfloat16`` (bf16
    matmul operands, fp32 accumulation and state). Differentiable in
    ``params``, ``carry0`` and ``xs``.
    """
    return _gru_x_streams([params], [carry0], [xs], resets, compute_dtype)[0]


def gru_sequence_pair(params_pair, carry0_pair, xs_pair, resets: torch.Tensor,
                      compute_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent GRU replays with shared resets in one launch per
    kernel; equal to two :func:`gru_sequence_x` calls. Returns ``(hs_a, hs_b)``."""
    hs = _gru_x_streams(list(params_pair), list(carry0_pair), list(xs_pair), resets, compute_dtype)
    return hs[0], hs[1]
