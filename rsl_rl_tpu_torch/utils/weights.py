"""Carry weights of a JAX ``ActorCritic(Recurrent)`` into the port.

The JAX policy's state arrives as nested dicts of numpy arrays:

- ``params``: ``{"actor": {"dense_i": {"kernel" [in,out], "bias"}}, "critic": ...,
  "std": [A], "memory_a"/"memory_c": {"cell_i": {"ir"/"iz"/"in": {"kernel",
  "bias"}, "hr"/"hz": {"kernel"}, "hn": {"kernel", "bias"}}}}`` (flax
  ``Dense`` and ``GRUCell`` layouts);
- ``norm``: ``{"actor"/"critic": {"mean", "var", "count"} or None}``.

GRU cells are packed as the JAX package's ``_gru_pack`` packs them (gates
r|z|n): ``wx = [ir|iz|in]`` ``[D,3H]``, ``bx`` ``[3H]``, ``wh = [hr|hz|hn]``
``[H,3H]``, ``bhn`` ``[H]``. The port keeps its own copy of these layout
maps; it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

_GATES = ("r", "z", "n")


def pack_gru_cell(cell: dict) -> dict[str, np.ndarray]:
    """flax ``GRUCell`` params -> the packed ``wx``, ``bx``, ``wh``, ``bhn``."""
    return {
        "wx": np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in _GATES], axis=1),
        "bx": np.concatenate([np.asarray(cell[f"i{g}"]["bias"]) for g in _GATES]),
        "wh": np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]) for g in _GATES], axis=1),
        "bhn": np.asarray(cell["hn"]["bias"]),
    }


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = torch.tensor(np.asarray(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: expected shape {tuple(dst.shape)}, got {tuple(src.shape)}")
    dst.copy_(src.to(dst.device))


@torch.no_grad()
def from_jax_state(params_np: dict, norm_np: dict, policy) -> None:
    """Load JAX policy parameters and normalizer moments into ``policy`` (in place)."""
    for net in ("actor", "critic"):
        mlp = getattr(policy, net)
        for i in range(mlp.num_linear):
            layer = getattr(mlp, f"dense_{i}")
            src = params_np[net][f"dense_{i}"]
            _copy(layer.weight, np.asarray(src["kernel"]).T, f"{net}.dense_{i}.kernel")
            _copy(layer.bias, src["bias"], f"{net}.dense_{i}.bias")
    _copy(policy.std, params_np["std"], "std")
    if policy.is_recurrent:
        for mem in ("memory_a", "memory_c"):
            memory = getattr(policy, mem)
            for layer in range(memory.num_layers):
                packed = pack_gru_cell(params_np[mem][f"cell_{layer}"])
                cell = getattr(memory, f"cell_{layer}")
                for key, value in packed.items():
                    _copy(getattr(cell, key), value, f"{mem}.cell_{layer}.{key}")
    for role in ("actor", "critic"):
        state = getattr(policy, f"norm_{role}")
        src = norm_np.get(role)
        if (state is None) != (src is None):
            raise ValueError(f"normalizer '{role}': JAX and port configurations differ")
        if state is not None:
            for key in ("mean", "var", "count"):
                _copy(getattr(state, key), src[key], f"norm.{role}.{key}")
