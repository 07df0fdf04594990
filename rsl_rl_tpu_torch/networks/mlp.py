"""Configurable MLP (counterpart of ``rsl_rl_tpu/networks/mlp.py``), fp32.

Layers are ``dense_{i}`` ``nn.Linear``s with torch's default init,
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weight and bias, drawn from an
explicit generator.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from rsl_rl_tpu_torch.utils.resolvers import resolve_nn_activation


class MLP(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dims: Sequence[int],
        activation: str = "elu",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.act = resolve_nn_activation(activation)
        dims = [input_dim, *hidden_dims, output_dim]
        self.num_linear = len(dims) - 1
        for i in range(self.num_linear):
            layer = nn.Linear(dims[i], dims[i + 1])
            bound = 1.0 / math.sqrt(dims[i])
            with torch.no_grad():
                layer.weight.uniform_(-bound, bound, generator=generator)
                layer.bias.uniform_(-bound, bound, generator=generator)
            self.add_module(f"dense_{i}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_linear):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_linear - 1:
                x = self.act(x)
        return x
