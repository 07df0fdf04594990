"""Data parallelism with host (non-tensor) environments (counterpart of
``rsl_rl_tpu/parallel/host_dp.py``).

Each rank steps its own host env shard of ``n_local`` envs; the policy, the
normalizers and the update run on the rank's device over that shard, and the
data group's collectives make the math that of one process over the global
batch of ``n_local * data_size`` envs (``algorithms/ppo.py``: the global
noise draws, the global normalizer moments, the global minibatches).
:class:`HostShardingBridge` is the seam: in the port a "global" tensor is
this rank's shard on its own device, the shards concatenated in data-rank
order as JAX concatenates them in process order, so its conversions are the
host-device copies of one shard.

The rank-0 contract of ``host_dp.py:25-28`` holds: the episode statistics of
a window stay this rank's, and rank 0 logs and saves.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from rsl_rl_tpu_torch.parallel.mesh import Mesh, replicated, shard_tree
from rsl_rl_tpu_torch.storage.rollout import tree_map


def to_device(tree, device=None):
    """A numpy tree -> tensors on ``device``."""
    return tree_map(lambda x: torch.as_tensor(np.asarray(x), device=device), tree)


def to_host(tree):
    """A tensor tree -> numpy on the host."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def converters(bridge, device=None):
    """``(to_device, to_host)`` for a possibly-None bridge: numpy trees to
    tensors on ``device`` (the bridge's by default) and back."""
    if bridge is not None:
        return bridge.to_global, bridge.to_local_np
    return partial(to_device, device=device), to_host


class HostShardingBridge:
    """This rank's host shard <-> its shard of the global batch on the device,
    over the data axis of ``mesh``."""

    def __init__(self, mesh: Mesh, device=None):
        self.mesh = mesh
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.num_processes = mesh.data_size

    def global_batch(self, local_batch: int) -> int:
        """The global env count of ``local_batch`` envs a rank."""
        return local_batch * self.mesh.data_size

    def to_global(self, tree):
        """This rank's numpy shard ``[n_local, ...]`` -> its shard of the
        global batch, tensors on the device."""
        return to_device(tree, self.device)

    def to_local_np(self, tree):
        """This rank's shard of the global batch -> numpy on the host."""
        return to_host(tree)

    def replicate(self, tree):
        """A host tree meant to be the same on every rank -> tensors on the
        device, data rank 0's on every rank (a broadcast)."""
        return shard_tree(self.to_global(tree), replicated(self.mesh))

    def constrain_time_major(self, tree):
        """Check that stacked ``[T, n_local, ...]`` window tensors are one
        shard: every tensor of two or more dims has the same env count on
        axis 1. Returns ``tree``."""
        counts = set()
        tree_map(lambda x: counts.add(x.shape[1]) if x.ndim >= 2 else None, tree)
        if len(counts) > 1:
            raise ValueError(f"a time-major window mixes env counts {sorted(counts)}")
        return tree
