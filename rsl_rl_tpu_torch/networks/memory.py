"""Recurrent memory with an explicit carry (counterpart of
``rsl_rl_tpu/networks/memory.py``), GRU only.

- acting: ``Memory.step(carry, x)``, one plain-PyTorch step per call;
- BPTT replay: ``Memory.sequence`` / ``Memory.sequence_with_carry`` /
  :func:`paired_sequence`, through the
  GRU replay of ``ops.gru_rnn`` (CUDA kernels on the card, the plain version
  on the CPU), with the carry zeroed where ``resets[t]`` is set.

Each layer ``cell_{i}`` holds the packed weights of the JAX package's
``_gru_pack``: ``wx [D,3H]``, ``bx [3H]``, ``wh [H,3H]``, ``bhn [H]`` (gates
r|z|n). Init is torch's RNN default, ``U(-1/sqrt(H), 1/sqrt(H))``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rsl_rl_tpu_torch.ops.gru_rnn import gru_sequence_pair, gru_sequence_x, gru_step

_LSTM_TODO = (
    "LSTM memories are not ported yet (ROADMAP.md Queue 2, 'LSTM x-streaming' and"
    " 'LSTM x-streaming, stream-paired')"
)


class GRUCellParams(nn.Module):
    """The packed weights of one GRU layer."""

    def __init__(self, input_dim: int, hidden: int, generator=None, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden)

        def init(*shape):
            t = torch.empty(shape, dtype=torch.float32, device=device)
            return nn.Parameter(t.uniform_(-bound, bound, generator=generator))

        self.wx = init(input_dim, 3 * hidden)
        self.bx = init(3 * hidden)
        self.wh = init(hidden, 3 * hidden)
        self.bhn = init(hidden)

    def params(self) -> dict[str, torch.Tensor]:
        return {"wx": self.wx, "bx": self.bx, "wh": self.wh, "bhn": self.bhn}


class Memory(nn.Module):
    """Stacked GRU layers.

    Args:
        input_dim: width of the input of layer 0.
        hidden_size: hidden width of every layer.
        rnn_type: ``"gru"``; ``"lstm"`` raises ``NotImplementedError``.
        num_layers: number of stacked layers.
        compute_dtype: ``None`` (IEEE fp32) or ``torch.bfloat16`` (bf16 matmul
            operands, fp32 state), the same scheme when acting and replaying.
    """

    def __init__(self, input_dim: int, hidden_size: int = 256, rnn_type: str = "gru",
                 num_layers: int = 1, compute_dtype=None, generator=None, device=None):
        super().__init__()
        if rnn_type.lower() != "gru":
            raise NotImplementedError(_LSTM_TODO)
        self.rnn_type = "gru"
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        for layer in range(num_layers):
            d = input_dim if layer == 0 else hidden_size
            self.add_module(f"cell_{layer}", GRUCellParams(d, hidden_size, generator, device))

    def cell(self, layer: int) -> dict[str, torch.Tensor]:
        return getattr(self, f"cell_{layer}").params()

    def initialize_carry(self, batch_size: int, device=None) -> tuple[torch.Tensor, ...]:
        """Zero carry: one ``[B, H]`` hidden state per layer."""
        return tuple(
            torch.zeros(batch_size, self.hidden_size, device=device) for _ in range(self.num_layers)
        )

    def step(self, carry, x: torch.Tensor):
        """One recurrent step: returns ``(new_carry, out)``."""
        new_carry = []
        out = x
        for layer in range(self.num_layers):
            out = gru_step(self.cell(layer), carry[layer], out, self.compute_dtype)
            new_carry.append(out)
        return tuple(new_carry), out

    def sequence(self, carry0, xs: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
        """BPTT replay of a ``[T, B, D]`` window, layer by layer; ``[T, B, H]``."""
        return self.sequence_with_carry(carry0, xs, resets)[0]

    def sequence_with_carry(self, carry0, xs: torch.Tensor, resets: torch.Tensor):
        """:meth:`sequence` that also returns the carry after the last step.

        The returned carry is value-only (detached): it serves truncated-BPTT
        replay, which cuts the gradient at segment boundaries.
        """
        out = xs
        finals = []
        for layer in range(self.num_layers):
            out = gru_sequence_x(self.cell(layer), carry0[layer], out, resets, self.compute_dtype)
            finals.append(out[-1].detach())
        return out, tuple(finals)


def paired_sequence(mem_a: Memory, carry0_a, xs_a: torch.Tensor,
                    mem_b: Memory, carry0_b, xs_b: torch.Tensor,
                    resets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Replay two memories over the same window and resets (the actor and
    critic of a recurrent PPO minibatch), each layer's two replays in one
    stream-paired launch when the memories are twins and the inputs have one
    shape; otherwise two :meth:`Memory.sequence` calls. Same result either way."""
    twins = (
        mem_a.hidden_size == mem_b.hidden_size
        and mem_a.num_layers == mem_b.num_layers
        and mem_a.compute_dtype == mem_b.compute_dtype
        and xs_a.shape == xs_b.shape
    )
    if not twins:
        return mem_a.sequence(carry0_a, xs_a, resets), mem_b.sequence(carry0_b, xs_b, resets)
    out_a, out_b = xs_a, xs_b
    for layer in range(mem_a.num_layers):
        out_a, out_b = gru_sequence_pair(
            (mem_a.cell(layer), mem_b.cell(layer)),
            (carry0_a[layer], carry0_b[layer]),
            (out_a, out_b),
            resets,
            compute_dtype=mem_a.compute_dtype,
        )
    return out_a, out_b


def mask_carry(carry, reset_mask: torch.Tensor):
    """Zero the carry rows where ``reset_mask [N]`` (bool) is set."""
    keep = 1.0 - reset_mask.to(torch.float32)[:, None]
    return tuple(h * keep for h in carry)


def memory_sequence(mem: Memory, carry0, xs: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
    """Replay a window one :meth:`Memory.step` at a time (the acting math),
    zeroing the carry where ``resets[t]`` is set: the reference that the fused
    replay must reproduce."""
    carry = carry0
    outs = []
    for t in range(xs.shape[0]):
        carry, out = mem.step(mask_carry(carry, resets[t]), xs[t])
        outs.append(out)
    return torch.stack(outs)
