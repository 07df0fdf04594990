"""Training runners."""

from rsl_rl_tpu_torch.runners.distillation_runner import DistillationRunner
from rsl_rl_tpu_torch.runners.multiseed import make_multiseed_train
from rsl_rl_tpu_torch.runners.multiseed_runner import MultiSeedRunner
from rsl_rl_tpu_torch.runners.on_policy_runner import OnPolicyRunner

__all__ = ["DistillationRunner", "MultiSeedRunner", "OnPolicyRunner", "make_multiseed_train"]
