"""Vectorized environments; importing registers them by class name."""

from rsl_rl_tpu_torch.env.nlink import DomainRandomizedNLink, NLinkPendulum
from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv

__all__ = ["DomainRandomizedNLink", "EnvState", "NLinkPendulum", "VecEnv"]
