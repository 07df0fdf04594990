"""The reference's LSTM memory: one layer of rsl_rl's ``ActorCriticRecurrent``
memory (``rnn_type="lstm"``), written from the layer's equations.

Gates i|f|g|o, the carry ``(c, h)`` each ``[N,H]``, the trunk reads ``h``:

    a  = x Wx + h Wh + bh
    c' = sigmoid(a_f) * c + sigmoid(a_i) * tanh(a_g)
    h' = sigmoid(a_o) * tanh(c')

Departures from the source's ``torch.nn.LSTM``, which the port shares:

- the weights are packed, in the port's leaf names and order: ``wx [D,4H]``
  (``weight_ih`` transposed), ``wh [H,4H]`` (``weight_hh`` transposed),
  ``bh [4H]``, each ``U(-1/sqrt(H), 1/sqrt(H))`` as torch draws them;
- one bias where ``torch.nn.LSTM`` adds two, ``b_ih + b_hh``: their sum is
  the one parameter the equations see;
- in bf16 (the configuration's ``dtype`` bfloat16) every matmul operand
  is rounded to bf16 and held in fp32, and the products are accumulated in
  fp32, where the source computes in fp32: in the step's products ``x Wx``
  and ``h Wh`` and in the four products of their backward (the gradient of
  ``a`` times each rounded weight, each rounded input times the gradient of
  ``a``, that gradient rounded too); ``c`` and ``h`` and the bias stay fp32.
  The control's ``op`` (float8 operands) is applied to each rounded operand.

IEEE fp32 or bf16 operands; any other dtype is refused. TF32 stays off
(``harness.set_precision``).
"""

from __future__ import annotations

import math

import torch

from portbench.harness import SpecError


def layout(input_dim: int, H: int) -> list[tuple[str, tuple, float]]:
    """``(leaf, shape, bound)`` of the layer, in the optimizer's order."""
    b = 1.0 / math.sqrt(H)
    return [("wx", (input_dim, 4 * H), b), ("wh", (H, 4 * H), b), ("bh", (4 * H,), b)]


def zeros(N: int, H: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.zeros(N, H, device=device), torch.zeros(N, H, device=device)


def _round(t: torch.Tensor, op) -> torch.Tensor:
    """A matmul operand rounded to bf16 (held in fp32), then ``op``'s."""
    return op(t.to(torch.bfloat16).to(torch.float32))


class _Bf16Matmul(torch.autograd.Function):
    """``a @ b`` from bf16 operands with fp32 accumulation, the backward's
    two products alike."""

    @staticmethod
    def forward(ctx, a, b, op):
        ra, rb = _round(a, op), _round(b, op)
        ctx.save_for_backward(ra, rb)
        ctx.op = op
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = _round(g, ctx.op)
        return torch.matmul(rg, rb.transpose(-1, -2)), torch.matmul(ra.transpose(-1, -2), rg), None


def _matmul(a: torch.Tensor, b: torch.Tensor, dtype, op) -> torch.Tensor:
    """A product in the configuration's precision."""
    return torch.matmul(a, b) if dtype is None else _Bf16Matmul.apply(a, b, op)


def step(P: dict, carry: tuple, x: torch.Tensor, dtype, op) -> tuple[torch.Tensor, torch.Tensor]:
    """One step, ``carry = (c, h)``, ``x [N,D]`` -> ``(c', h')``; ``dtype``
    None (fp32) or ``torch.bfloat16`` (bf16 operands, fp32 accumulation
    and state), ``op`` the control's rounding of a bf16 operand."""
    if dtype not in (None, torch.bfloat16):
        raise SpecError(f"the LSTM reference computes in fp32 or with bf16 operands, not {dtype}")
    c, h = carry
    H = P["wh"].shape[0]
    a = _matmul(x, P["wx"], dtype, op) + _matmul(h, P["wh"], dtype, op) + P["bh"]
    i = torch.sigmoid(a[..., :H])
    f = torch.sigmoid(a[..., H:2 * H])
    g = torch.tanh(a[..., 2 * H:3 * H])
    o = torch.sigmoid(a[..., 3 * H:])
    c = f * c + i * g
    return c, o * torch.tanh(c)


def output(carry: tuple) -> torch.Tensor:
    return carry[1]
