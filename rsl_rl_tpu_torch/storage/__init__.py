"""Rollout storage and minibatch indexing."""

from rsl_rl_tpu_torch.storage.rollout import Rollout, recurrent_minibatch_starts, slice_envs

__all__ = ["Rollout", "recurrent_minibatch_starts", "slice_envs"]
