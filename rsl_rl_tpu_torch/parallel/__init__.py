"""Data- and tensor-parallel training on ``torch.distributed`` (counterpart of
``rsl_rl_tpu/parallel``): rank layouts and placement (``mesh.py``), host-env
shards (``host_dp.py``) and model-sharded MLP trunks (``tp.py``)."""

from rsl_rl_tpu_torch.parallel.host_dp import HostShardingBridge, converters
from rsl_rl_tpu_torch.parallel.mesh import (
    Mesh,
    data_sharding,
    distributed_init,
    global_mean,
    global_sum,
    make_mesh,
    make_tp_mesh,
    replicated,
    shard_tree,
    time_major_sharding,
    tree_shardings,
)
from rsl_rl_tpu_torch.parallel.tp import gather_tree_tp, shard_tree_tp, tp_tree_shardings

__all__ = [
    "Mesh",
    "HostShardingBridge",
    "converters",
    "distributed_init",
    "make_mesh",
    "make_tp_mesh",
    "replicated",
    "data_sharding",
    "time_major_sharding",
    "shard_tree",
    "tree_shardings",
    "global_sum",
    "global_mean",
    "tp_tree_shardings",
    "shard_tree_tp",
    "gather_tree_tp",
]
