"""PyTorch/CUDA port of rsl_rl_tpu.

The JAX package ``rsl_rl_tpu`` stays the reference; this package mirrors its
layout (``env``, ``ops``, ``networks``, ``modules``, ``storage``,
``algorithms``, ``runners``, ``utils``) and runs on an NVIDIA GPU. The GRU
replay that the JAX package wrote as Pallas kernels is hand-written CUDA here
(``csrc/gru_x.cu``, bound in ``ops/gru_rnn.py``).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
there is no silent CPU fallback. The package imports ``torch`` and ``numpy``
only, never ``jax`` or anything of ``rsl_rl_tpu``.
"""

from rsl_rl_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
