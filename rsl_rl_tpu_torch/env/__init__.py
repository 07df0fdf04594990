"""Vectorized environments; importing registers the functional ones by class
name. The host envs (``host_env.py``, ``mujoco_host.py``) are stateful and
numpy-based; ``mujoco_host`` imports ``mujoco`` only when an env is built."""

from rsl_rl_tpu_torch.env.cartpole import CartPoleSwingUp
from rsl_rl_tpu_torch.env.hopper import Hopper
from rsl_rl_tpu_torch.env.host_env import GymVecEnv, HostVecEnv
from rsl_rl_tpu_torch.env.mujoco_host import MuJoCoHostEnv, MuJoCoNLinkEnv
from rsl_rl_tpu_torch.env.nlink import DomainRandomizedNLink, NLinkPendulum, PartiallyObservableNLink
from rsl_rl_tpu_torch.env.pendulum import PartiallyObservablePendulum, Pendulum, PrivilegedPendulum
from rsl_rl_tpu_torch.env.reacher import Reacher
from rsl_rl_tpu_torch.env.sparse import SparseGoalReach
from rsl_rl_tpu_torch.env.toy import PointMass
from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv

__all__ = ["CartPoleSwingUp", "DomainRandomizedNLink", "EnvState", "GymVecEnv", "Hopper", "HostVecEnv",
           "MuJoCoHostEnv", "MuJoCoNLinkEnv", "NLinkPendulum", "PartiallyObservableNLink",
           "PartiallyObservablePendulum", "Pendulum", "PointMass", "PrivilegedPendulum", "Reacher",
           "SparseGoalReach", "VecEnv"]
