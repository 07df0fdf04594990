"""Rank layouts for data- and tensor-parallel training on ``torch.distributed``
(counterpart of ``rsl_rl_tpu/parallel/mesh.py``).

The JAX package shards arrays over a device mesh and lets XLA insert the
collectives; the port runs one process a rank and places the same math by
hand:

- a :class:`Mesh` is the ranks of the process group laid out as ``("data",)``
  or ``("data", "model")``, ``model`` innermost (rank ``r`` holds data rank
  ``r // M`` and model rank ``r % M``), with a process group for each axis;
- a "global" tensor is this rank's shard on its own device: the global batch
  is implicit in the ranks, shards concatenated in data-rank order (as JAX
  concatenates them in device order);
- the math that must not depend on the layout runs through the mesh's
  collectives: :func:`global_sum` / :func:`global_mean` over the data group,
  the gradients summed there, the row-parallel products over the model group.

Without an initialized process group :func:`make_mesh` gives the one-rank
mesh, whose collectives do nothing. An initialized group of one (an NCCL
group on one card) runs every collective. Inside an iteration each
collective that runs lies between two of the tracer's device stamps
(``exchange``, ``utils/trace.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from rsl_rl_tpu_torch.storage.rollout import tree_map
from rsl_rl_tpu_torch.utils import trace


def distributed_init(**kwargs) -> bool:
    """Initialize the process group (the counterpart of ``mesh.py``'s
    ``distributed_init`` and of the reference's ``init_process_group``).

    With arguments (``backend``, ``init_method``, ``rank``, ``world_size``,
    ``device_id``) it initializes with them; without, it initializes from
    the torchrun markers (``WORLD_SIZE`` > 1 and ``RANK`` in the
    environment, ``init_method="env://"``); with neither it does nothing and
    returns False. The backend is named, never probed: NCCL when
    ``device_id`` is a CUDA device, else Gloo, unless ``backend`` says.
    Returns True when it initialized the group.
    """
    if not kwargs:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or "RANK" not in os.environ:
            return False
        kwargs = {"init_method": "env://", "rank": int(os.environ["RANK"]),
                  "world_size": int(os.environ["WORLD_SIZE"])}
        local = os.environ.get("LOCAL_RANK")
        if local is not None and torch.cuda.is_available():
            kwargs["device_id"] = torch.device("cuda", int(local))
    kwargs = dict(kwargs)
    device = kwargs.get("device_id")
    if device is not None:
        device = torch.device(device)
        kwargs["device_id"] = device
    kwargs.setdefault("backend", "nccl" if device is not None and device.type == "cuda" else "gloo")
    if kwargs["backend"] != "nccl":
        # device_id binds a communicator to a card; Gloo has none to bind
        kwargs.pop("device_id", None)
    dist.init_process_group(**kwargs)
    return True


@dataclass(eq=False)
class Mesh:
    """The ranks as a ``data x model`` grid and a process group per axis.

    ``data_group`` joins the ranks of this rank's model rank (they hold
    different env shards), ``model_group`` those of its data rank (they hold
    the same shard and different slices of the MLP trunks). A group is None
    where the axis has one rank or no process group is initialized
    (``distributed`` False): its collectives do nothing."""

    axis_names: tuple
    data_size: int
    model_size: int
    rank: int
    data_group: Any = None
    model_group: Any = None
    distributed: bool = False

    @property
    def size(self) -> int:
        return self.data_size * self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    def __deepcopy__(self, memo):
        # modules that hold the mesh (the normalizers, the MLPs) are copied
        # with it shared: a process group is not copied
        return self

    # ------------------------------------------------------------ collectives

    def data_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data group, in place; returns ``t``."""
        if self.data_group is not None:
            with trace.interval("exchange"):
                dist.all_reduce(t, group=self.data_group)
        return t

    def model_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group, in place; returns ``t``."""
        if self.model_group is not None:
            with trace.interval("exchange"):
                dist.all_reduce(t, group=self.model_group)
        return t

    def model_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate the model group's ``t`` along ``dim`` in model-rank order."""
        if self.model_size == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.model_size)]
        with trace.interval("exchange"):
            dist.all_gather(parts, t.contiguous(), group=self.model_group)
        return torch.cat(parts, dim=dim)

    def data_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate the data group's ``t`` along ``dim`` in data-rank order."""
        if self.data_group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.data_size)]
        with trace.interval("exchange"):
            dist.all_gather(parts, t.contiguous(), group=self.data_group)
        return torch.cat(parts, dim=dim)

    def data_broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Overwrite ``t`` with data rank 0's, in place; returns ``t``."""
        if self.data_group is not None and self.data_size > 1:
            with trace.interval("exchange"):
                dist.broadcast(t, src=self.model_rank, group=self.data_group)
        return t


def _groups(data: int, model: int, rank: int):
    """This rank's data and model process groups (None for an axis of one
    rank, over which a sum is the identity; a group of one rank in all keeps
    ``WORLD``, so its collectives run). Every rank creates every group, in
    the same order, as ``new_group`` requires."""
    if model == 1:
        return dist.group.WORLD, None
    if data == 1:
        return None, dist.group.WORLD
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return data_group, model_group


def _layout(model: int) -> Mesh:
    if model < 1:
        raise ValueError(f"model-axis size {model} must divide the rank count and be >= 1")
    if not dist.is_initialized():
        if model != 1:
            raise ValueError(f"model-axis size {model} must divide the rank count 1 (no process group is"
                             " initialized: see distributed_init)")
        return Mesh(("data",), 1, 1, 0)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model:
        raise ValueError(f"model-axis size {model} must divide the rank count {world}")
    data_group, model_group = _groups(world // model, model, rank)
    names = ("data",) if model == 1 else ("data", "model")
    return Mesh(names, world // model, model, rank, data_group, model_group, distributed=True)


def make_mesh() -> Mesh:
    """The 1-D ``("data",)`` layout over every rank of the process group (one
    rank without a group)."""
    return _layout(1)


def make_tp_mesh(model: int) -> Mesh:
    """The 2-D ``("data", "model")`` layout with ``model``-way tensor
    parallelism, ``model`` innermost (``tp.py:37-50``). Raises ``ValueError``
    when ``model`` does not divide the rank count."""
    return _layout(int(model))


# ------------------------------------------------------------------ placement


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: ``axis=None`` replicated over the
    data group, else this rank's contiguous slice of ``axis``."""

    mesh: Mesh
    axis: int | None


def replicated(mesh: Mesh) -> Sharding:
    """Every data rank holds the whole tensor (placed by a broadcast from
    data rank 0)."""
    return Sharding(mesh, None)


def data_sharding(mesh: Mesh) -> Sharding:
    """This rank's contiguous slice of the leading (env) axis."""
    return Sharding(mesh, 0)


def time_major_sharding(mesh: Mesh) -> Sharding:
    """This rank's contiguous slice of the env axis of ``[T, N, ...]``."""
    return Sharding(mesh, 1)


def local_slice(mesh: Mesh, n_global: int) -> tuple[int, int]:
    """``(offset, size)`` of this rank's contiguous share of ``n_global``
    rows; raises ``ValueError`` when the data axis does not divide them."""
    if n_global % mesh.data_size:
        raise ValueError(f"the data-axis size {mesh.data_size} must divide the global count {n_global}")
    n = n_global // mesh.data_size
    return mesh.data_rank * n, n


def shard_tree(tree: Any, sharding: Sharding) -> Any:
    """Place every tensor of a nested dict/tuple/list with ``sharding``: a
    slice of the sharded axis (a view), or a broadcast from data rank 0."""
    mesh, axis = sharding.mesh, sharding.axis
    if axis is None:
        return tree_map(mesh.data_broadcast_, tree)

    def one(t):
        offset, n = local_slice(mesh, t.shape[axis])
        return t.narrow(axis, offset, n)

    return tree_map(one, tree)


def tree_shardings(tree: Any, sharding: Sharding) -> Any:
    """A tree of ``sharding`` matching ``tree``'s structure."""
    return tree_map(lambda _: sharding, tree)


def global_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of every element of ``x`` over the data group."""
    s = x.sum()
    return s if mesh is None else mesh.data_sum_(s.reshape(1))[0]


def global_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of every element of ``x`` over the data group's equal shards:
    the sum of each shard's mean over the shard count (on a group of one
    exactly ``x.mean()``)."""
    if mesh is None:
        return x.mean()
    return mesh.data_sum_((x.mean() / mesh.data_size).reshape(1))[0]


def global_mean_std(x: torch.Tensor, mesh: Mesh | None, n_global: int | None = None):
    """``(mean, unbiased std)`` of every element of ``x`` over the data group,
    ``n_global`` elements in all (equal shards by default); a shard may be
    empty. Each rank's mean and unbiased variance are combined with the
    shards' weights, ``M2 = sum (n_i - 1) var_i + n_i (mean_i - mean)^2``,
    in two sums, so a group of one gives ``x.mean()`` and ``x.std()``
    exactly (``var_i`` is ``x.std()`` squared, and ``sqrt`` of a float's
    square is the float)."""
    if mesh is None:
        return x.mean(), x.std()
    n = x.numel()
    N = n * mesh.data_size if n_global is None else int(n_global)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    mean_i = x.mean() if n else zero
    var_i = torch.square(x.std()) if n > 1 else zero
    mean = mesh.data_sum_((mean_i * (n / N)).reshape(1))[0]
    var = var_i * (max(n - 1, 0) / (N - 1)) + torch.square(mean_i - mean) * (n / (N - 1))
    return mean, torch.sqrt(mesh.data_sum_(var.reshape(1))[0])
