"""Vectorized environments; importing registers the functional ones by class
name. The host envs (``host_env.py``, ``mujoco_host.py``) are stateful and
numpy-based; ``mujoco_host`` imports ``mujoco`` only when an env is built.
The simulator adapters (``mjx_env.py``, ``brax_env.py``) take an MJX-shaped
simulator or a Brax-shaped env on torch tensors from the caller."""

from rsl_rl_tpu_torch.env.brax_env import BraxVecEnv
from rsl_rl_tpu_torch.env.cartpole import CartPoleSwingUp
from rsl_rl_tpu_torch.env.hopper import Hopper
from rsl_rl_tpu_torch.env.host_env import GymVecEnv, HostVecEnv
from rsl_rl_tpu_torch.env.mjx_env import MJXEnv
from rsl_rl_tpu_torch.env.mujoco_host import MuJoCoHostEnv, MuJoCoNLinkEnv
from rsl_rl_tpu_torch.env.nlink import DomainRandomizedNLink, NLinkPendulum, PartiallyObservableNLink
from rsl_rl_tpu_torch.env.pendulum import PartiallyObservablePendulum, Pendulum, PrivilegedPendulum
from rsl_rl_tpu_torch.env.reacher import Reacher
from rsl_rl_tpu_torch.env.sparse import SparseGoalReach
from rsl_rl_tpu_torch.env.toy import PointMass
from rsl_rl_tpu_torch.env.vec_env import EnvState, VecEnv

__all__ = ["BraxVecEnv", "CartPoleSwingUp", "DomainRandomizedNLink", "EnvState", "GymVecEnv", "Hopper",
           "HostVecEnv", "MJXEnv", "MuJoCoHostEnv", "MuJoCoNLinkEnv", "NLinkPendulum", "PartiallyObservableNLink",
           "PartiallyObservablePendulum", "Pendulum", "PointMass", "PrivilegedPendulum", "Reacher",
           "SparseGoalReach", "VecEnv"]
