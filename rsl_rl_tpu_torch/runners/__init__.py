"""Training runners."""

from rsl_rl_tpu_torch.runners.distillation_runner import DistillationRunner
from rsl_rl_tpu_torch.runners.multiseed import make_multiseed_train
from rsl_rl_tpu_torch.runners.multiseed_runner import MultiSeedRunner
from rsl_rl_tpu_torch.runners.on_policy_runner import OnPolicyRunner
from rsl_rl_tpu_torch.runners.pbt import PBTState, make_pbt_train

__all__ = ["DistillationRunner", "MultiSeedRunner", "OnPolicyRunner", "PBTState", "make_multiseed_train",
           "make_pbt_train"]
