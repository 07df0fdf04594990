"""The N-link pendulum's step as one CUDA kernel (``csrc/nlink.cu``) and its wrapper.

``NLinkPendulum.step`` (``env/nlink.py``) launches :func:`step` for a state on
a CUDA device and runs its plain PyTorch step, op by op, for one on the CPU;
there is no fallback between the two. The kernel does the whole step of every
env in one launch, one thread an env: the action clamp and joint torques, the
substeps (mass matrix, Coriolis and gravity terms, the unrolled Cholesky
solve, the speed clamp), the tip height and reward, the episode clock and
time limit, the next key and its reset draws, and the choice of the reset
state where the env is done. Each op rounds as the plain step's CUDA op does
and each sum over the links takes the order of torch's reduce kernel, so the
two give the same bits on the card (``csrc/nlink.cu``).

What varies between the env classes comes in as tensors and counts, never as
the class: the couplings ``K_ij l_i l_j`` and ``g l_i K_ii`` of one plant
(``[L, L]`` and ``[L]``) or of one plant an env (``[N, L, L]`` and ``[N,
L]``, ``DomainRandomizedNLink``), the time limit as an int or an ``[N]``
int32 tensor, and the hash draws a reset takes: ``2L`` for theta and omega
and any more, whose raw bits come back in :attr:`StepOutputs.extra_bits` for
the subclass to map to its per-episode fields.

:data:`launches` counts the kernel's launches (a plain integer;
``IterationGraph`` adds a graph replay's captured launches back), and each
launch also counts ``env.kernel`` on the tracer's open iteration
(``utils/trace.py``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from rsl_rl_tpu_torch.utils import trace

#: the most links the kernel takes (its factor stays in registers)
MAX_LINKS = 8
#: launches of the step kernel since the process started
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_I, _P, _L, _P, _L] + [_P] * 9 + [_I] * 4 + [_P, _P]
_N_CONSTS = 13
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from rsl_rl_tpu_torch.utils.cuda_build import load_library

        fn = load_library("nlink").nlink_step
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@dataclass
class StepOutputs:
    """What the kernel writes: the stepped (and where done, reset) state,
    and the step's reward, done, tip height and extra reset draws."""

    theta: torch.Tensor  # [N, L] fp32
    omega: torch.Tensor  # [N, L] fp32
    episode_length: torch.Tensor  # [N] int32
    rng: torch.Tensor  # [N] int64, the envs' next keys
    reward: torch.Tensor  # [N] fp32
    done: torch.Tensor  # [N] bool, every done a time-out
    height: torch.Tensor  # [N] fp32, the tip height over the chain's length
    extra_bits: torch.Tensor  # [N, reset_draws - 2L] int64


def _check(name: str, t, shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``t`` in the layout the kernel reads (contiguous: a reset's state is
    made of column slices); raises where its type, shape or device differ."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got one on {t.device}")
    return t.contiguous()


def _plant(name: str, t, shape: tuple, n: int, device: torch.device) -> tuple[torch.Tensor, int]:
    """A coupling given for one plant (``shape``) or one plant an env
    (``[n, *shape]``), and its env stride; raises otherwise."""
    if isinstance(t, torch.Tensor) and t.dim() == len(shape) + 1:
        t = _check(name, t, (n, *shape), torch.float32, device)
        return t, t.stride(0)
    return _check(name, t, shape, torch.float32, device), 0


def step(theta, omega, actions, episode_length, keys, max_episode_length, coup, gdiag, lengths, *,
         reset_draws: int, n_substeps: int, h: float, max_torque: float, max_speed: float, damping: float,
         total_len: float, theta_range: tuple[float, float], omega_range: tuple[float, float],
         pivot_floor: float, speed_cost: float, effort_cost: float) -> StepOutputs:
    """One step of the ``N`` envs of a state on one CUDA device, in one launch.

    ``theta``, ``omega``, ``actions`` ``[N, L]`` fp32 (1 <= L <= :data:`MAX_LINKS`),
    ``episode_length`` ``[N]`` int32, ``keys`` ``[N]`` int64 (the state's
    ``rng``), ``max_episode_length`` an int or ``[N]`` int32, ``coup`` ``[L,
    L]`` or ``[N, L, L]`` and ``gdiag`` ``[L]`` or ``[N, L]`` fp32 (the
    couplings), ``lengths`` ``[L]`` fp32; every tensor on the same CUDA
    device (one that is not contiguous is copied). ``reset_draws`` (at
    least ``2L``) is the hash draws a reset takes, ``h`` the substep's
    seconds, ``total_len`` the chain's length, the ranges ``(low, width)``
    those of the reset draws of theta and omega, ``pivot_floor`` the floor
    of the Cholesky pivots, and ``speed_cost`` / ``effort_cost`` the
    reward's weights on the mean squared speed and torque. Raises ``ValueError`` /
    ``TypeError`` on what the kernel does not take and ``RuntimeError`` when
    the launch fails.
    """
    if not isinstance(theta, torch.Tensor) or theta.dim() != 2:
        raise ValueError(f"theta: expected an [N, L] tensor, got {getattr(theta, 'shape', type(theta).__name__)}")
    n, L = theta.shape
    if not 1 <= L <= MAX_LINKS:
        raise ValueError(f"the step kernel takes 1 <= L <= {MAX_LINKS} links, got L={L}")
    device = theta.device
    theta = _check("theta", theta, (n, L), torch.float32, device)
    omega = _check("omega", omega, (n, L), torch.float32, device)
    actions = _check("actions", actions, (n, L), torch.float32, device)
    episode_length = _check("episode_length", episode_length, (n,), torch.int32, device)
    keys = _check("keys", keys, (n,), torch.int64, device)
    lengths = _check("lengths", lengths, (L,), torch.float32, device)
    coup, coup_stride = _plant("coup", coup, (L, L), n, device)
    gdiag, gdiag_stride = _plant("gdiag", gdiag, (L,), n, device)
    if isinstance(max_episode_length, torch.Tensor):
        max_episode_length = _check("max_episode_length", max_episode_length, (n,), torch.int32, device)
        limits, limit = max_episode_length.data_ptr(), 0
    elif isinstance(max_episode_length, int) and 0 <= max_episode_length < 2**31:
        limits, limit = None, max_episode_length
    else:
        raise ValueError(f"max_episode_length: expected an int in [0, 2^31) or an [N] int32 tensor,"
                         f" got {max_episode_length!r}")
    if reset_draws < 2 * L:
        raise ValueError(f"reset_draws: a reset draws theta and omega, at least 2L = {2 * L}, got {reset_draws}")
    if device.type != "cuda":
        raise ValueError(f"the step kernel takes CUDA tensors, got them on {device}")

    # the fp32 constants as torch's ops round them: Python floats cast to fp32,
    # a division by a Python float as the product with its fp32 reciprocal, and
    # the means' factor as torch's mean kernel computes it
    f32 = np.float32
    consts = (max_torque, max_speed, damping, h, f32(1.0) / f32(total_len), f32(n) / f32(n * L),
              *theta_range, *omega_range, pivot_floor, speed_cost, effort_cost)
    c_consts = (ctypes.c_float * _N_CONSTS)(*(float(v) for v in consts))

    out = StepOutputs(
        theta=torch.empty_like(theta), omega=torch.empty_like(omega), episode_length=torch.empty_like(episode_length),
        rng=torch.empty_like(keys), reward=torch.empty(n, dtype=torch.float32, device=device),
        done=torch.empty(n, dtype=torch.bool, device=device), height=torch.empty(n, dtype=torch.float32, device=device),
        extra_bits=torch.empty((n, reset_draws - 2 * L), dtype=torch.int64, device=device))
    err = _kernel()(
        theta.data_ptr(), omega.data_ptr(), actions.data_ptr(), episode_length.data_ptr(), keys.data_ptr(),
        limits, limit, coup.data_ptr(), coup_stride, gdiag.data_ptr(), gdiag_stride, lengths.data_ptr(),
        out.theta.data_ptr(), out.omega.data_ptr(), out.episode_length.data_ptr(), out.rng.data_ptr(),
        out.reward.data_ptr(), out.done.data_ptr(), out.height.data_ptr(), out.extra_bits.data_ptr(),
        n, L, reset_draws - 2 * L, n_substeps, ctypes.addressof(c_consts),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nlink_step: CUDA error {err} at launch")
    global launches
    launches += 1
    trace.count("env.kernel")
    return out
