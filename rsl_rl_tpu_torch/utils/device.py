"""Device resolution: CUDA unless the caller asks for the CPU, no fallback."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``, raising when CUDA is asked for but absent.

    The port never falls back to the CPU on its own: a caller that wants the
    CPU (the tests) passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass"
            " device='cpu' to run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
