"""PyTorch/CUDA port of rsl_rl_tpu.

The JAX package ``rsl_rl_tpu`` stays the reference; this package mirrors its
layout (``env``, ``ops``, ``networks``, ``modules``, ``storage``,
``algorithms``, ``runners``, ``utils``) and runs on an NVIDIA GPU. The GRU
and LSTM replays that the JAX package wrote as Pallas kernels are hand-written
CUDA here (``csrc/gru_x.cu``, ``csrc/lstm_x.cu``, ``csrc/gru_xp.cu``,
``csrc/lstm_xp.cu``, bound in ``ops/gru_rnn.py`` and ``ops/lstm_rnn.py``).
Multi-seed training (``runners.MultiSeedRunner``) batches G seeds with
``torch.func.vmap`` where the JAX package uses ``jax.vmap``; student-teacher
distillation (``runners.DistillationRunner``) distils a teacher loaded from
a PPO checkpoint. External simulators that keep their own state train
through ``env.HostVecEnv`` (stepped on the host, the policy on the card);
``utils.export`` and ``utils.torch_deploy`` carry a trained policy out.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
there is no silent CPU fallback. The package imports ``torch`` and ``numpy``
only, never ``jax`` or anything of ``rsl_rl_tpu``.
"""

from rsl_rl_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
