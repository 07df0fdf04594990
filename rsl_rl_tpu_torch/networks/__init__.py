"""Network primitives: MLP and recurrent memory."""

from rsl_rl_tpu_torch.networks.memory import Memory, mask_carry, memory_sequence
from rsl_rl_tpu_torch.networks.mlp import MLP

__all__ = ["MLP", "Memory", "mask_carry", "memory_sequence"]
