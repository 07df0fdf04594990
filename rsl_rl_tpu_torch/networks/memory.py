"""Recurrent memory with an explicit carry (counterpart of
``rsl_rl_tpu/networks/memory.py``), GRU or LSTM.

- acting: ``Memory.step(carry, x)``, one plain-PyTorch step per call;
- BPTT replay: ``Memory.sequence`` / ``Memory.sequence_with_carry`` /
  :func:`paired_sequence`, through the GRU replay of ``ops.gru_rnn`` or the
  LSTM replay of ``ops.lstm_rnn`` (CUDA kernels on the card, the plain
  version on the CPU), with the carry zeroed where ``resets[t]`` is set. A
  layer whose input is wider than ``X_STREAM_MAX_D`` takes the xproj replay,
  as do all replays under ``torch.func.vmap`` (the seed axis of multi-seed
  training; the x-streaming replays' vmap rules route there). A memory wider
  than ``KERNEL_MAX_HIDDEN`` replays one :meth:`Memory.step` at a time
  (:func:`memory_sequence_with_carry`, plain PyTorch on every device), as the
  JAX package's replay takes its scan where the kernels' shape gate says no;
  the route is chosen by shape before any launch.

Each layer ``cell_{i}`` holds the packed weights of the JAX package's
``_gru_pack`` (``wx [D,3H]``, ``bx [3H]``, ``wh [H,3H]``, ``bhn [H]``, gates
r|z|n) or ``_lstm_pack`` (``wx [D,4H]``, ``wh [H,4H]``, ``bh [4H]``, gates
i|f|g|o). The carry is one ``h [B,H]`` per GRU layer and one ``(c, h)`` per
LSTM layer. Init is torch's RNN default, ``U(-1/sqrt(H), 1/sqrt(H))``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rsl_rl_tpu_torch.ops.gru_rnn import gru_sequence, gru_sequence_pair, gru_step
from rsl_rl_tpu_torch.ops.lstm_rnn import lstm_sequence_pair, lstm_sequence_with_carry, lstm_step
from rsl_rl_tpu_torch.ops.rnn_common import KERNEL_MAX_HIDDEN, X_STREAM_MAX_D

_CELL_SHAPES = {
    "gru": lambda d, h: {"wx": (d, 3 * h), "bx": (3 * h,), "wh": (h, 3 * h), "bhn": (h,)},
    "lstm": lambda d, h: {"wx": (d, 4 * h), "wh": (h, 4 * h), "bh": (4 * h,)},
}


class CellParams(nn.Module):
    """The packed weights of one GRU or LSTM layer."""

    def __init__(self, rnn_type: str, input_dim: int, hidden: int, generator=None, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden)
        self.names = tuple(_CELL_SHAPES[rnn_type](input_dim, hidden))
        for name, shape in _CELL_SHAPES[rnn_type](input_dim, hidden).items():
            t = torch.empty(shape, dtype=torch.float32, device=device)
            self.register_parameter(name, nn.Parameter(t.uniform_(-bound, bound, generator=generator)))

    def params(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self.names}


class Memory(nn.Module):
    """Stacked GRU or LSTM layers.

    Args:
        input_dim: width of the input of layer 0.
        hidden_size: hidden width of every layer.
        rnn_type: ``"gru"`` or ``"lstm"``.
        num_layers: number of stacked layers.
        compute_dtype: ``None`` (IEEE fp32) or ``torch.bfloat16`` (bf16 matmul
            operands, fp32 state), the same scheme when acting and replaying.
    """

    def __init__(self, input_dim: int, hidden_size: int = 256, rnn_type: str = "lstm",
                 num_layers: int = 1, compute_dtype=None, generator=None, device=None):
        super().__init__()
        self.rnn_type = rnn_type.lower()
        if self.rnn_type not in _CELL_SHAPES:
            raise ValueError(f"rnn_type must be 'gru' or 'lstm', got {rnn_type!r}")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        for layer in range(num_layers):
            d = input_dim if layer == 0 else hidden_size
            self.add_module(f"cell_{layer}", CellParams(self.rnn_type, d, hidden_size, generator, device))

    def cell(self, layer: int) -> dict[str, torch.Tensor]:
        return getattr(self, f"cell_{layer}").params()

    def initialize_carry(self, batch_size: int, device=None):
        """Zero carry: per layer ``h [B, H]`` (GRU) or ``(c, h)`` (LSTM)."""

        def zeros():
            return torch.zeros(batch_size, self.hidden_size, device=device)

        if self.rnn_type == "gru":
            return tuple(zeros() for _ in range(self.num_layers))
        return tuple((zeros(), zeros()) for _ in range(self.num_layers))

    def step(self, carry, x: torch.Tensor):
        """One recurrent step: returns ``(new_carry, out)``."""
        new_carry = []
        out = x
        for layer in range(self.num_layers):
            if self.rnn_type == "gru":
                layer_carry = out = gru_step(self.cell(layer), carry[layer], out, self.compute_dtype)
            else:
                layer_carry = lstm_step(self.cell(layer), carry[layer], out, self.compute_dtype)
                out = layer_carry[1]
            new_carry.append(layer_carry)
        return tuple(new_carry), out

    def sequence(self, carry0, xs: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
        """BPTT replay of a ``[T, B, D]`` window, layer by layer; ``[T, B, H]``."""
        return self.sequence_with_carry(carry0, xs, resets)[0]

    def sequence_with_carry(self, carry0, xs: torch.Tensor, resets: torch.Tensor):
        """:meth:`sequence` that also returns the carry after the last step.

        The returned carry is value-only (detached): it serves truncated-BPTT
        replay, which cuts the gradient at segment boundaries.
        """
        if self.hidden_size > KERNEL_MAX_HIDDEN:
            out, final = memory_sequence_with_carry(self, carry0, xs, resets)
            return out, _detach(final)
        out = xs
        finals = []
        for layer in range(self.num_layers):
            if self.rnn_type == "gru":
                out = gru_sequence(self.cell(layer), carry0[layer], out, resets, self.compute_dtype)
                finals.append(out[-1].detach())
            else:
                out, final = lstm_sequence_with_carry(self.cell(layer), carry0[layer], out, resets,
                                                      self.compute_dtype)
                finals.append(final)
        return out, tuple(finals)


def paired_sequence(mem_a: Memory, carry0_a, xs_a: torch.Tensor,
                    mem_b: Memory, carry0_b, xs_b: torch.Tensor,
                    resets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Replay two memories over the same window and resets (the actor and
    critic of a recurrent PPO minibatch), each layer's two replays in one
    stream-paired launch when the memories are twins, the inputs have one
    shape, every layer's input is at most ``X_STREAM_MAX_D`` wide and the
    hidden size at most ``KERNEL_MAX_HIDDEN`` (the JAX package's pair gate);
    otherwise two :meth:`Memory.sequence` calls. Same result either way."""
    twins = (
        mem_a.rnn_type == mem_b.rnn_type
        and mem_a.hidden_size == mem_b.hidden_size
        and mem_a.num_layers == mem_b.num_layers
        and mem_a.compute_dtype == mem_b.compute_dtype
        and xs_a.shape == xs_b.shape
    )
    # layer 0 takes D, deeper layers H: every layer must pass the gate
    widths = {xs_a.shape[-1]} | ({mem_a.hidden_size} if mem_a.num_layers > 1 else set())
    if not (twins and max(widths) <= X_STREAM_MAX_D and mem_a.hidden_size <= KERNEL_MAX_HIDDEN):
        return mem_a.sequence(carry0_a, xs_a, resets), mem_b.sequence(carry0_b, xs_b, resets)
    pair_fn = gru_sequence_pair if mem_a.rnn_type == "gru" else lstm_sequence_pair
    out_a, out_b = xs_a, xs_b
    for layer in range(mem_a.num_layers):
        out_a, out_b = pair_fn(
            (mem_a.cell(layer), mem_b.cell(layer)),
            (carry0_a[layer], carry0_b[layer]),
            (out_a, out_b),
            resets,
            compute_dtype=mem_a.compute_dtype,
        )
    return out_a, out_b


def mask_carry(carry, reset_mask: torch.Tensor):
    """Zero the carry rows where ``reset_mask [N]`` (bool) is set; the carry
    is a tensor or nested tuples of tensors (an LSTM layer's ``(c, h)``)."""
    if isinstance(carry, torch.Tensor):
        return carry * (1.0 - reset_mask.to(torch.float32)[:, None])
    return tuple(mask_carry(c, reset_mask) for c in carry)


def _detach(carry):
    if isinstance(carry, torch.Tensor):
        return carry.detach()
    return tuple(_detach(c) for c in carry)


def memory_sequence_with_carry(mem: Memory, carry0, xs: torch.Tensor, resets: torch.Tensor):
    """Replay a window one :meth:`Memory.step` at a time (the acting math),
    zeroing the carry where ``resets[t]`` is set: ``(outs [T,B,H], the carry
    after the last step)``. The replay of memories wider than the kernels
    take (the JAX package's ``memory_sequence_with_carry``), and the reference
    that the kernel replay must reproduce. Plain PyTorch, so it also runs
    under ``torch.func.vmap``."""
    carry = carry0
    outs = []
    for t in range(xs.shape[0]):
        carry, out = mem.step(mask_carry(carry, resets[t]), xs[t])
        outs.append(out)
    return torch.stack(outs), carry


def memory_sequence(mem: Memory, carry0, xs: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
    """:func:`memory_sequence_with_carry`'s outputs alone."""
    return memory_sequence_with_carry(mem, carry0, xs, resets)[0]
