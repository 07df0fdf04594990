"""Configurable MLP (counterpart of ``rsl_rl_tpu/networks/mlp.py``).

Layers are ``dense_{i}`` ``nn.Linear``s with torch's default init,
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weight and bias, drawn from an
explicit generator; ``init_scales`` (one gain, or a gain a layer) draws
orthogonal weights with those gains and zero biases instead. A tuple
``output_dim`` reshapes the output (``(2, A)``: ``[..., 2, A]``). Parameters
are fp32. With ``dtype=torch.bfloat16`` a
layer computes as flax ``nn.Dense(dtype=bfloat16)`` does: input, kernel and
bias cast to bf16, a bf16 matmul, the bias added in bf16, the activation in
bf16. ``head_dtype=torch.float32`` computes the last layer in fp32 (``None``
inherits ``dtype``); the output is fp32 either way.

Under tensor parallelism (``parallel/tp.py`` ``shard_module_tp`` sets
``tp_roles`` and ``tp_mesh``) a column-parallel ``dense_k`` multiplies the
whole input by its rows of the weight (the input's gradient summed over the
model group), a row-parallel one its slice of the input by its columns (the
partial products summed over the model group). In a bf16 layer both sums
run in fp32 and are rounded once to bf16 after them, forward and backward,
as the unsharded layer rounds its fp32 accumulation once; then the bias is
added. A column-parallel last layer gathers its output.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from rsl_rl_tpu_torch.utils.resolvers import resolve_nn_activation


def _check_dtype(name: str, dtype, allowed: tuple) -> None:
    if dtype not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {dtype}")


class MLP(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_dim: int | Sequence[int],
        hidden_dims: Sequence[int],
        activation: str = "elu",
        generator: torch.Generator | None = None,
        dtype=None,
        head_dtype=None,
        init_scales: float | Sequence[float] | None = None,
    ):
        super().__init__()
        _check_dtype("dtype", dtype, (None, torch.bfloat16))
        _check_dtype("head_dtype", head_dtype, (None, torch.float32))
        self.act = resolve_nn_activation(activation)
        self.activation = activation.lower()  # the name, for the deployment bridge (utils/torch_deploy.py)
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.out_shape = None if isinstance(output_dim, int) else tuple(output_dim)
        dims = [input_dim, *hidden_dims, output_dim if self.out_shape is None else math.prod(self.out_shape)]
        self.num_linear = len(dims) - 1
        if isinstance(init_scales, (list, tuple)) and len(init_scales) != self.num_linear:
            raise ValueError(f"init_scales has {len(init_scales)} gains for {self.num_linear} layers")
        for i in range(self.num_linear):
            layer = nn.Linear(dims[i], dims[i + 1])
            bound = 1.0 / math.sqrt(dims[i])
            with torch.no_grad():
                if init_scales is None:
                    layer.weight.uniform_(-bound, bound, generator=generator)
                    layer.bias.uniform_(-bound, bound, generator=generator)
                else:
                    gain = init_scales[i] if isinstance(init_scales, (list, tuple)) else init_scales
                    nn.init.orthogonal_(layer.weight, gain=float(gain), generator=generator)
                    layer.bias.zero_()
            self.add_module(f"dense_{i}", layer)
        #: ``"column"``, ``"row"`` or None a layer, and the mesh, under
        #: tensor parallelism (``parallel/tp.py``)
        self.tp_roles = None
        self.tp_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_roles is not None:
            return self._tp_forward(x)
        for i in range(self.num_linear):
            layer = getattr(self, f"dense_{i}")
            is_head = i == self.num_linear - 1
            dt = self.head_dtype if is_head and self.head_dtype is not None else self.dtype
            if dt is None:
                x = layer(x)
            else:
                x = torch.matmul(x.to(dt), layer.weight.to(dt).T) + layer.bias.to(dt)
            if not is_head:
                x = self.act(x)
        x = x.to(torch.float32)
        return x if self.out_shape is None else x.reshape(*x.shape[:-1], *self.out_shape)

    def _tp_forward(self, x: torch.Tensor) -> torch.Tensor:
        from rsl_rl_tpu_torch.parallel.tp import CopyToModel, GatherFromModel, ReduceFromModel

        mesh, split = self.tp_mesh, False
        for i, role in enumerate(self.tp_roles):
            layer = getattr(self, f"dense_{i}")
            is_head = i == self.num_linear - 1
            dt = self.head_dtype if is_head and self.head_dtype is not None else self.dtype
            if role != "row" and split:
                x, split = GatherFromModel.apply(x, mesh), False
            if role is None:
                x = layer(x) if dt is None else torch.matmul(x.to(dt), layer.weight.to(dt).T) + layer.bias.to(dt)
            elif dt is None:
                # a row-parallel layer's x is this rank's slice of the
                # features (a column-parallel layer always precedes it)
                if role == "row":
                    x = ReduceFromModel.apply(torch.matmul(x, layer.weight.T), mesh) + layer.bias
                else:
                    x = layer(CopyToModel.apply(x, mesh))
            else:
                # bf16 operands multiplied in fp32: the partial sums that
                # cross ranks (the row-parallel products forward, the
                # column-parallel input's gradient backward) stay fp32 until
                # the sum and are rounded to bf16 once after it
                xs, w = x.to(dt).float(), layer.weight.to(dt).float()
                if role == "row":
                    y = ReduceFromModel.apply(torch.matmul(xs, w.T), mesh)
                else:
                    y = torch.matmul(CopyToModel.apply(xs, mesh), w.T)
                x = y.to(dt) + layer.bias.to(dt)
            split = role == "column"
            if not is_head:
                x = self.act(x)
        if split:
            x = GatherFromModel.apply(x, mesh)
        x = x.to(torch.float32)
        return x if self.out_shape is None else x.reshape(*x.shape[:-1], *self.out_shape)
