"""What the GRU and LSTM window replays (``ops/gru_rnn.py``,
``ops/lstm_rnn.py``) share: the operand rounding of the bf16 mode, the
compute-dtype rule, the checks of the kernel wrappers, the tracer's marks
of the plain replays and the batching of the replays' ``torch.func.vmap``
rules (their launch counters are ``utils/trace.py``'s ``LaunchCounts``).

The tracer's ``memory`` span (``utils/trace.py``) times the replays inside
an iteration: on the card the kernel wrappers place its marks around each
launch (forward, backward, weight gradient), on the CPU :func:`marked`
places them around each of the plain versions the replays run there."""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from rsl_rl_tpu_torch.utils import trace

#: the most hidden columns the kernels take, as the JAX package's
#: single-stream kernels take within their VMEM budget (``csrc/rnn_common.cuh``
#: ``kMaxHidden``); ``Memory`` replays wider memories with its plain step loop
KERNEL_MAX_HIDDEN = 512
#: inputs wider than this take the xproj replay (the input projection as one
#: bulk product outside the kernels), as in the JAX package (``_X_STREAM_MAX_D``)
X_STREAM_MAX_D = 512
#: the weight-gradient reduction's block (``csrc/rnn_wgrad.cuh`` ``WgradCfg``),
#: by bf16 mode: the operand rows of its tile of C and the blocks an SM holds
#: at once (its launch bound); the columns of its tile, the most rows beyond
#: the full row tiles that the first row tile takes, the fewest of the T*B
#: rows a split walks and the most splits
WGRAD_TILE_ROWS = {False: 128, True: 256}
WGRAD_BLOCKS_PER_SM = {False: 2, True: 1}
WGRAD_TILE_COLS = 128
WGRAD_TAIL = 16
WGRAD_MIN_SPLIT_ROWS = 256
WGRAD_MAX_SPLITS = 64


def op(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A matmul operand: rounded to bf16 (and held in fp32) in bf16 mode."""
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


def mm(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """fp32-accumulated matmul of optionally bf16-rounded operands (the
    JAX package's ``_mm``). The product of two bf16 values is exact in fp32."""
    return torch.matmul(op(a, bf16), op(b, bf16))


def is_bf16(compute_dtype) -> bool:
    """``None`` -> IEEE fp32, ``torch.bfloat16`` -> bf16 operands; else raise."""
    if compute_dtype is None:
        return False
    if compute_dtype == torch.bfloat16:
        return True
    raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")


def marked(fn):
    """``fn`` (a plain replay function, the CPU's stand-in for one kernel
    launch) between the tracer's ``memory`` marks."""

    def run(*args):
        with trace.interval("memory"):
            return fn(*args)

    return run


def load_kernels(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (on first use) and load ``csrc/<name>.cu`` and type its entry points."""
    from rsl_rl_tpu_torch.utils.cuda_build import load_library

    lib = load_library(name)
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, t: torch.Tensor, shape: tuple) -> int:
    """The data pointer of a contiguous fp32 CUDA tensor of ``shape``; raises otherwise."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def raise_on(fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")


#: what the cluster forwards' plan entry points report, in order
#: (``csrc/rnn_fwd.cuh`` ``rnn_x_fwd_plan``)
FWD_PLAN_KEYS = ("active_clusters", "rows_per_cluster", "clusters", "resident", "tail_rows", "parts", "waves")


def fwd_plan(name: str, fn, *args) -> dict:
    """The grid a cluster forward chooses, from its plan entry point ``fn(*args, out)``:
    ``{"kernel": "cluster", ...}`` with the keys of :data:`FWD_PLAN_KEYS`, or
    ``{"kernel": "columns"}`` where the entry point reports no clusters (the
    xproj forwards' one-thread-per-column kernels)."""
    out = (ctypes.c_int * len(FWD_PLAN_KEYS))()
    raise_on(name, fn(*args, ctypes.addressof(out)))
    plan = dict(zip(FWD_PLAN_KEYS, out))
    if plan["clusters"] == 0:
        return {"kernel": "columns"}
    plan["resident"] = bool(plan["resident"])
    return {"kernel": "cluster", **plan}


def check_hidden(kind: str, H: int) -> None:
    if not 1 <= H <= KERNEL_MAX_HIDDEN:
        raise ValueError(f"{kind} kernels take 1 <= H <= {KERNEL_MAX_HIDDEN}, got H={H}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@dataclass(frozen=True)
class WgradPlan:
    """The grid of the weight-gradient reduction of ``C [S, H+D+1, 4H]``."""

    row_tiles: int  # row tiles of the H+D operand rows
    tail: int  # operand rows beyond them, taken by the first row tile's blocks
    col_tiles: int  # 128-column tiles of the 4H gate-gradient columns
    splits: int  # row splits P, each summed into its own partial C


def wgrad_plan(S: int, T: int, B: int, D: int, H: int, sms: int, bf16: bool = False) -> WgradPlan:
    """Tiles and split-K of the reduction (the kernel applies the same row
    rule): as many splits as fill the card's ``sms`` SMs once, at the mode's
    blocks an SM, with at least ``WGRAD_MIN_SPLIT_ROWS`` of the ``T*B`` rows
    a split."""
    M, tile = H + D, WGRAD_TILE_ROWS[bf16]
    if M >= tile and M % tile <= WGRAD_TAIL:
        row_tiles, tail = M // tile, M % tile
    else:
        row_tiles, tail = -(-M // tile), 0
    col_tiles = -(-4 * H // WGRAD_TILE_COLS)
    tiles = max(1, S * row_tiles * col_tiles)
    splits = min(WGRAD_BLOCKS_PER_SM[bf16] * sms // tiles, T * B // WGRAD_MIN_SPLIT_ROWS, WGRAD_MAX_SPLITS)
    return WgradPlan(row_tiles, tail, col_tiles, max(1, splits))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def wgrad_scratch(S: int, T: int, B: int, D: int, H: int, device, bf16: bool):
    """``(P, W, C)`` of a reduction launch on ``device``: its split count, the
    partial sums ``W [S,P,H+D+1,4H]`` (C itself when P == 1) and ``C``."""
    P = wgrad_plan(S, T, B, D, H, _sm_count(device.index), bf16).splits
    C = torch.empty((S, H + D + 1, 4 * H), dtype=torch.float32, device=device)
    W = C if P == 1 else torch.empty((S, P, H + D + 1, 4 * H), dtype=torch.float32, device=device)
    return P, W, C


def check_replay_inputs(kind: str, tensors) -> None:
    """One device for all replay inputs."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kind} replay inputs are on several devices: {sorted(map(str, devices))}")


def check_resets(kind: str, resets: torch.Tensor, G: int, T: int, B: int) -> None:
    """The xproj replays take one reset mask per stream (seeds have their own dones)."""
    if tuple(resets.shape) != (G, T, B):
        raise ValueError(f"{kind} xproj replay: resets must be [G, T, B] = {(G, T, B)},"
                         f" got {tuple(resets.shape)}")


def shared_resets(resets: torch.Tensor, S: int) -> torch.Tensor:
    """A ``[T,B]`` reset mask shared by S streams, as the xproj replays take
    it: ``[S,T,B]`` (a view)."""
    return resets.expand(S, *resets.shape)


def batch_first(t: torch.Tensor, dim, size: int) -> torch.Tensor:
    """In a ``torch.func.vmap`` rule: the argument with its vmapped axis first
    (``dim``), or expanded to ``size`` along a new first axis when unbatched."""
    if dim is None:
        return t.expand(size, *t.shape)
    return t.movedim(dim, 0)


def merge_streams(t: torch.Tensor) -> torch.Tensor:
    """``[V, G, ...]`` -> ``[V*G, ...]``: a vmapped axis folded into the stream axis."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])
