"""Carry weights of a JAX ``ActorCritic(Recurrent)`` or
``StudentTeacher(Recurrent)`` into the port.

The JAX policy's state arrives as nested dicts of numpy arrays:

- ``params``: ``{"actor": {"dense_i": {"kernel" [in,out], "bias"}}, "critic": ...,
  "std": [A], "memory_a"/"memory_c": {"cell_i": {"ir"/"iz"/"in": {"kernel",
  "bias"}, "hr"/"hz": {"kernel"}, "hn": {"kernel", "bias"}}}}`` (flax
  ``Dense`` and ``GRUCell`` layouts), or for an LSTM memory ``{"ii".."io":
  {"kernel"}, "hi".."ho": {"kernel", "bias"}}`` per cell (``OptimizedLSTMCell``);
- ``norm``: ``{"actor"/"critic": {"mean", "var", "count"} or None}``.

GRU cells are packed as the JAX package's ``_gru_pack`` packs them (gates
r|z|n): ``wx = [ir|iz|in]`` ``[D,3H]``, ``bx`` ``[3H]``, ``wh = [hr|hz|hn]``
``[H,3H]``, ``bhn`` ``[H]``. LSTM cells (flax ``OptimizedLSTMCell``: ``ii``..
``io`` without bias, ``hi``..``ho`` with) as ``_lstm_pack`` packs them (gates
i|f|g|o): ``wx = [ii|if|ig|io]`` ``[D,4H]``, ``wh = [hi|hf|hg|ho]`` ``[H,4H]``,
``bh`` ``[4H]``. The port keeps its own copy of these layout maps; it imports
nothing of the JAX package.

:func:`from_jax_rnd_state` loads a JAX ``RNDState`` (predictor, target,
both normalizers, counter) into the port's ``RandomNetworkDistillation``.

A multi-seed study's trees (``jax.vmap`` of the policy init) carry a leading
``[G]`` axis on every leaf; :func:`from_jax_stacked_state` loads them, one
seed or all, into the port's stacked training state, and
:func:`from_jax_stacked_rnd_state` a study's RND states.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

_GRU_GATES = ("r", "z", "n")
_LSTM_GATES = ("i", "f", "g", "o")


def pack_gru_cell(cell: dict) -> dict[str, np.ndarray]:
    """flax ``GRUCell`` params -> the packed ``wx``, ``bx``, ``wh``, ``bhn``."""
    return {
        "wx": np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in _GRU_GATES], axis=1),
        "bx": np.concatenate([np.asarray(cell[f"i{g}"]["bias"]) for g in _GRU_GATES]),
        "wh": np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]) for g in _GRU_GATES], axis=1),
        "bhn": np.asarray(cell["hn"]["bias"]),
    }


def pack_lstm_cell(cell: dict) -> dict[str, np.ndarray]:
    """flax ``OptimizedLSTMCell`` params -> the packed ``wx``, ``wh``, ``bh``."""
    return {
        "wx": np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in _LSTM_GATES], axis=1),
        "wh": np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]) for g in _LSTM_GATES], axis=1),
        "bh": np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _LSTM_GATES]),
    }


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = torch.tensor(np.asarray(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: expected shape {tuple(dst.shape)}, got {tuple(src.shape)}")
    dst.copy_(src.to(dst.device))


def _load_mlp(mlp, src: dict, name: str) -> None:
    for i in range(mlp.num_linear):
        layer = getattr(mlp, f"dense_{i}")
        _copy(layer.weight, np.asarray(src[f"dense_{i}"]["kernel"]).T, f"{name}.dense_{i}.kernel")
        _copy(layer.bias, src[f"dense_{i}"]["bias"], f"{name}.dense_{i}.bias")


def _load_memory(memory, src: dict, name: str) -> None:
    pack = pack_gru_cell if memory.rnn_type == "gru" else pack_lstm_cell
    for layer in range(memory.num_layers):
        cell = getattr(memory, f"cell_{layer}")
        for key, value in pack(src[f"cell_{layer}"]).items():
            _copy(getattr(cell, key), value, f"{name}.cell_{layer}.{key}")


def _load_norm(state, src, name: str) -> None:
    if (state is None) != (src is None):
        raise ValueError(f"normalizer '{name}': JAX and port configurations differ")
    if state is not None:
        for key in ("mean", "var", "count"):
            _copy(getattr(state, key), src[key], f"norm.{name}.{key}")


@torch.no_grad()
def from_jax_state(params_np: dict, norm_np: dict, policy, aux_np: dict | None = None) -> None:
    """Load JAX policy parameters and normalizer moments into ``policy`` (in place).

    An ``ActorCritic(Recurrent)``: ``params`` and ``norm`` as above. A
    ``StudentTeacher(Recurrent)``: ``params`` ``{"student", "std",
    "memory_s"}``, ``norm`` ``{"student"}`` and the JAX state's ``aux``
    ``{"teacher", "teacher_norm", "memory_t"}`` (normalizers as ``{"mean",
    "var", "count"}`` or None).
    """
    if getattr(policy, "std", None) is not None:  # a state-dependent std is in the actor's [H, 2A] head
        _copy(policy.std, params_np["std"], "std")
    elif params_np.get("std") is not None:
        raise ValueError("std: the JAX policy has a std parameter, the port's is state-dependent")
    if "student" in params_np:
        _load_mlp(policy.student, params_np["student"], "student")
        _load_mlp(policy.teacher, aux_np["teacher"], "teacher")
        if policy.is_recurrent:
            _load_memory(policy.memory_s, params_np["memory_s"], "memory_s")
            if policy.teacher_recurrent:
                _load_memory(policy.memory_t, aux_np["memory_t"], "memory_t")
        _load_norm(policy.norm_student, norm_np.get("student"), "student")
        _load_norm(policy.norm_teacher, aux_np.get("teacher_norm"), "teacher")
        return
    for net in ("actor", "critic"):
        _load_mlp(getattr(policy, net), params_np[net], net)
    if policy.is_recurrent:
        for mem in ("memory_a", "memory_c"):
            _load_memory(getattr(policy, mem), params_np[mem], mem)
    for role in ("actor", "critic"):
        _load_norm(getattr(policy, f"norm_{role}"), norm_np.get(role), role)


@torch.no_grad()
def from_jax_rnd_state(rnd_np: dict, rnd) -> None:
    """Load a JAX ``RNDState`` into a ``RandomNetworkDistillation`` (in
    place): ``rnd_np`` holds ``predictor`` and ``target`` (flax ``MLP``
    params), ``state_norm`` (``{"mean", "var", "count"}`` or None),
    ``reward_norm`` (``{"mean", "var", "count", "avg"}``: the scalar
    normalizer's moments and the per-env accumulator, or None) and
    ``counter``."""
    _load_mlp(rnd.predictor, rnd_np["predictor"], "rnd.predictor")
    _load_mlp(rnd.target, rnd_np["target"], "rnd.target")
    _load_norm(rnd.state_norm, rnd_np.get("state_norm"), "rnd_state")
    reward_np = rnd_np.get("reward_norm")
    _load_norm(None if rnd.reward_norm is None else rnd.reward_norm.emp, reward_np, "rnd_reward")
    if reward_np is not None:
        _copy(rnd.reward_norm.avg, reward_np["avg"], "rnd.reward_norm.avg")
    rnd.counter.copy_(torch.as_tensor(int(np.asarray(rnd_np["counter"]))))


def _take(tree, index: int):
    """Leaf ``index`` of the leading axis of every array of a nested dict."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _take(v, index) for k, v in tree.items()}
    return np.asarray(tree)[index]


@torch.no_grad()
def from_jax_stacked_state(params_np: dict, norm_np: dict, policy, state, seeds=None) -> None:
    """Load seed-stacked JAX policy parameters and normalizer moments (every
    leaf ``[G, ...]``) into a stacked training state in place: ``state.params``
    and ``state.buffers`` (``algorithms.ppo.StackedTrainState``), by module
    name with a leading ``[G]`` axis.

    ``policy`` is the architecture template (left unchanged); ``seeds`` is
    one seed index, a list of them, or ``None`` for all.
    """
    num_seeds = next(iter(state.params.values())).shape[0]
    if seeds is None:
        seeds = range(num_seeds)
    elif isinstance(seeds, int):
        seeds = [seeds]
    scratch = copy.deepcopy(policy)
    for g in seeds:
        from_jax_state(_take(params_np, g), _take(norm_np, g), scratch)
        for name, t in scratch.named_parameters():
            state.params[name][g].copy_(t)
        for name, t in scratch.named_buffers():
            state.buffers[name][g].copy_(t)


@torch.no_grad()
def from_jax_stacked_rnd_state(rnd_np: dict, rnd, state, seeds=None) -> None:
    """Load seed-stacked JAX ``RNDState`` trees (every leaf ``[G, ...]``, the
    dict of :func:`from_jax_rnd_state`) into a stacked training state's
    ``rnd_params`` / ``rnd_buffers`` in place. ``rnd`` is the template
    module, its reward normalizer sized for one seed's envs (left unchanged);
    ``seeds`` as in :func:`from_jax_stacked_state`."""
    num_seeds = next(iter(state.rnd_params.values())).shape[0]
    seeds = range(num_seeds) if seeds is None else ([seeds] if isinstance(seeds, int) else seeds)
    scratch = copy.deepcopy(rnd)
    for g in seeds:
        from_jax_rnd_state(_take(rnd_np, g), scratch)
        for name, t in scratch.named_parameters():
            state.rnd_params[name][g].copy_(t)
        for name, t in scratch.named_buffers():
            state.rnd_buffers[name][g].copy_(t)
