"""Training runners."""

from rsl_rl_tpu_torch.runners.on_policy_runner import OnPolicyRunner

__all__ = ["OnPolicyRunner"]
