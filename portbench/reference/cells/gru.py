"""The reference's GRU memory: one layer of the port's packed GRU.

Weights in the port's leaf names and order: ``wx [D,3H]``, ``bx [3H]``,
``wh [H,3H]``, ``bhn [H]``, gates r|z|n, each ``U(-1/sqrt(H), 1/sqrt(H))``.
The carry is one ``h [N,H]``, which the trunk reads.

    r  = sigmoid(x Wx_r + bx_r + h Wh_r)
    z  = sigmoid(x Wx_z + bx_z + h Wh_z)
    n  = tanh(x Wx_n + bx_n + r * (h Wh_n + bhn))
    h' = (1 - z) * n + z * h

IEEE fp32 only. The port rounds a bf16 memory's matmul operands to bf16
(fp32 accumulation and state); this file does not, so it refuses that
dtype rather than compare the port against other arithmetic.
"""

from __future__ import annotations

import math

import torch

from portbench.harness import SpecError


def layout(input_dim: int, H: int) -> list[tuple[str, tuple, float]]:
    """``(leaf, shape, bound)`` of the layer, in the optimizer's order."""
    b = 1.0 / math.sqrt(H)
    return [("wx", (input_dim, 3 * H), b), ("bx", (3 * H,), b), ("wh", (H, 3 * H), b), ("bhn", (H,), b)]


def zeros(N: int, H: int, device) -> torch.Tensor:
    return torch.zeros(N, H, device=device)


def step(P: dict, h: torch.Tensor, x: torch.Tensor, dtype, op) -> torch.Tensor:
    """One step, ``h [N,H]``, ``x [N,D]`` -> ``h'``. ``op`` (the control's
    operand rounding) has no bf16 operand to reach in fp32."""
    if dtype is not None:
        raise SpecError(f"the GRU reference computes IEEE fp32 only, not {dtype}: the port rounds a "
                        "bf16 memory's operands to bf16, which this reference does not follow")
    wx, bx, wh, bhn = P["wx"], P["bx"], P["wh"], P["bhn"]
    H = wh.shape[0]
    xp = torch.matmul(x, wx) + bx
    hp = torch.matmul(h, wh)
    r = torch.sigmoid(xp[..., :H] + hp[..., :H])
    z = torch.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
    n = torch.tanh(xp[..., 2 * H:] + r * (hp[..., 2 * H:] + bhn))
    return (1.0 - z) * n + z * h


def output(h: torch.Tensor) -> torch.Tensor:
    return h
