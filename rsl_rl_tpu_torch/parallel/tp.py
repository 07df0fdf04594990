"""Tensor-parallel (model-sharded) MLP trunks over a ``("data", "model")``
layout (counterpart of ``rsl_rl_tpu/parallel/tp.py``).

The JAX package places the state with partition specs and lets GSPMD insert
the collectives; the port slices the same leaves by the same rules and runs
the Megatron pair of collectives in ``networks/mlp.py``:

- even layers are column-parallel when ``out % M == 0``: each model rank
  holds rows ``[out/M]`` of ``dense_k.weight`` ``[out, in]`` and the bias
  slice, and computes a slice of the output features;
- odd layers are row-parallel when ``in % M == 0``: each rank holds columns
  ``[in/M]`` of the weight and multiplies its slice of the input features;
  the partial products are summed over the model group and the replicated
  bias is added after the sum;
- every other leaf (the last layer where its width does not divide, the
  normalizers, the memories, the std) stays replicated.

torch's ``nn.Linear.weight`` is ``[out, in]``, flax's kernel ``[in, out]``:
a column-parallel weight is split along dim 0 here where the JAX spec is
``P(None, "model")``. Specs are tuples of axis names, one a dim: ``("model",
None)``, ``(None, "model")``, ``("model",)`` or ``()`` (replicated).
"""

from __future__ import annotations

import re

import torch

from rsl_rl_tpu_torch.parallel.mesh import Mesh

_DENSE = re.compile(r"(?:^|\.)dense_(\d+)\.(weight|bias)$")


def leaf_spec(name: str, shape: tuple, model_size: int) -> tuple:
    """The spec of one state-dict leaf by the rules of ``tp.py:67-89``."""
    match = _DENSE.search(name)
    if match is None or model_size == 1:
        return ()
    layer, kind = int(match.group(1)), match.group(2)
    column = layer % 2 == 0
    if kind == "weight":
        if len(shape) != 2:
            return ()
        out, inp = shape
        if column and out % model_size == 0:
            return ("model", None)
        if not column and inp % model_size == 0:
            return (None, "model")
        return ()
    # the bias of a column-parallel layer is sliced; a row-parallel layer adds
    # its bias after the sum, so it stays whole
    if column and len(shape) >= 1 and shape[-1] % model_size == 0:
        return ("model",)
    return ()


def tp_tree_shardings(state_dict: dict, model_size: int) -> dict:
    """``{name: spec}`` for every tensor of a (full) state dict: the policy's
    or an optimizer moment dict keyed by parameter name, whose leaves shard
    as the parameters they track."""
    return {k: leaf_spec(k, tuple(v.shape), model_size) for k, v in state_dict.items()}


def _sharded_dim(spec: tuple) -> int | None:
    return spec.index("model") if "model" in spec else None


def shard_tree_tp(state_dict: dict, mesh: Mesh, specs: dict | None = None) -> dict:
    """This model rank's slice of every leaf of a full state dict (``specs``
    from :func:`tp_tree_shardings` of the full shapes by default)."""
    specs = tp_tree_shardings(state_dict, mesh.model_size) if specs is None else specs
    out = {}
    for k, v in state_dict.items():
        # a leaf the specs do not know (another policy's state) stays whole
        dim = _sharded_dim(specs.get(k, ()))
        if dim is None:
            out[k] = v
        else:
            n = v.shape[dim] // mesh.model_size
            out[k] = v.narrow(dim, mesh.model_rank * n, n).clone()
    return out


def gather_tree_tp(state_dict: dict, mesh: Mesh, specs: dict) -> dict:
    """The full state dict from every model rank's slices (``specs`` of the
    full shapes): the inverse of :func:`shard_tree_tp`, for checkpoints.
    Every rank of the model group calls it."""
    out = {}
    for k, v in state_dict.items():
        dim = _sharded_dim(specs[k])
        out[k] = v if dim is None else mesh.model_gather(v, dim)
    return out


@torch.no_grad()
def shard_module_tp(module: torch.nn.Module, mesh: Mesh) -> dict:
    """Shard every MLP trunk of ``module`` over the model group, in place: each
    sliced parameter keeps its object (an optimizer's references stay valid)
    and takes its slice as data, and each MLP runs its column- and
    row-parallel layers with the Megatron collectives. Returns the specs of
    the full state dict (:func:`tp_tree_shardings`)."""
    from rsl_rl_tpu_torch.networks.mlp import MLP

    specs = tp_tree_shardings(module.state_dict(), mesh.model_size)
    reshard_module_tp(module, mesh, specs)
    roles = {("model", None): "column", (None, "model"): "row"}
    for prefix, sub in module.named_modules():
        if isinstance(sub, MLP):
            prefix = f"{prefix}." if prefix else ""
            sub.tp_roles = [roles.get(specs[f"{prefix}dense_{i}.weight"]) for i in range(sub.num_linear)]
            sub.tp_mesh = mesh
    return specs


@torch.no_grad()
def unshard_module_tp(module: torch.nn.Module, mesh: Mesh, specs: dict) -> None:
    """Give every sliced parameter its full data again (gathered over the
    model group), in place; :func:`reshard_module_tp` slices it back."""
    for name, p in module.named_parameters():
        dim = _sharded_dim(specs[name])
        if dim is not None:
            p.data = mesh.model_gather(p.data, dim)


@torch.no_grad()
def reshard_module_tp(module: torch.nn.Module, mesh: Mesh, specs: dict) -> None:
    """Slice every parameter that :func:`unshard_module_tp` made whole."""
    for name, p in module.named_parameters():
        dim = _sharded_dim(specs[name])
        if dim is not None:
            n = p.shape[dim] // mesh.model_size
            p.data = p.data.narrow(dim, mesh.model_rank * n, n).clone()


def sharded_mask(names: list, specs: dict) -> list:
    """One bool a named parameter: whether it is sliced over the model group."""
    return [_sharded_dim(specs[n]) is not None for n in names]


# ------------------------------------------------- the Megatron collectives


class CopyToModel(torch.autograd.Function):
    """Identity forward, sum over the model group backward: the input of a
    column-parallel layer, whose gradient each rank holds a part of. The
    parts are summed in fp32 and rounded once to the gradient's dtype."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.model_sum_(grad.to(torch.float32, copy=True)).to(grad.dtype), None


class ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward, identity backward: the partial
    products of a row-parallel layer."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_sum_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class GatherFromModel(torch.autograd.Function):
    """All-gather of the last axis forward, this rank's slice backward: the
    output of a column-parallel layer that no row-parallel layer follows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return mesh.model_gather(x, -1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.mesh.model_rank * ctx.width, ctx.width), None
