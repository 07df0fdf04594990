"""Compute ops: distribution math, GAE, running normalization, and the GRU
and LSTM replays with their CUDA kernels (``gru_rnn``, ``lstm_rnn``,
imported by path).

The JAX package's ``init_running_norm`` and
``init_discounted_variation_norm`` have no counterpart: the port's
normalizer states are modules, built by their constructors
(``RunningNormState(dim)``, ``DiscountedVariationNormState(...)``)."""

from rsl_rl_tpu_torch.ops import distributions
from rsl_rl_tpu_torch.ops.gae import compute_gae, whiten
from rsl_rl_tpu_torch.ops.running_norm import (
    DiscountedVariationNormState,
    RunningNormState,
    denormalize,
    normalize,
    normalize_reward,
    update_running_norm,
)

__all__ = ["distributions", "compute_gae", "whiten", "RunningNormState", "DiscountedVariationNormState",
           "normalize", "denormalize", "normalize_reward", "update_running_norm"]
