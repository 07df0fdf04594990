"""Utility layer: config loading, the class registry, resolvers and
trajectory padding (the JAX package's ``rsl_rl_tpu.utils`` names); the other
modules (checkpoints, writers, CUDA builds and graphs, export) are imported
by path."""

from rsl_rl_tpu_torch.utils.config import load_train_cfg
from rsl_rl_tpu_torch.utils.registry import register, registered, resolve
from rsl_rl_tpu_torch.utils.resolvers import (
    resolve_nn_activation,
    resolve_obs_groups,
    resolve_optimizer,
    string_to_callable,
)
from rsl_rl_tpu_torch.utils.trajectories import split_and_pad_trajectories, unpad_trajectories

__all__ = ["load_train_cfg", "register", "registered", "resolve", "resolve_nn_activation", "resolve_obs_groups",
           "resolve_optimizer", "string_to_callable", "split_and_pad_trajectories", "unpad_trajectories"]
