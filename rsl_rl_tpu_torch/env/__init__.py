"""Vectorized environments; importing registers them by class name."""

from rsl_rl_tpu_torch.env.nlink import DomainRandomizedNLink, NLinkPendulum, PartiallyObservableNLink
from rsl_rl_tpu_torch.env.pendulum import PartiallyObservablePendulum, Pendulum, PrivilegedPendulum
from rsl_rl_tpu_torch.env.toy import PointMass
from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv

__all__ = ["DomainRandomizedNLink", "EnvState", "NLinkPendulum", "PartiallyObservableNLink",
           "PartiallyObservablePendulum", "Pendulum", "PointMass", "PrivilegedPendulum", "VecEnv"]
