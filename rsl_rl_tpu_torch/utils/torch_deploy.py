"""Deployment bridge to the upstream reference's torch layout (counterpart of
``rsl_rl_tpu/utils/torch_deploy.py``).

- :func:`as_torch_policy` turns a trained policy into a standalone
  ``nn.Module`` built of ``torch.nn`` parts only (the normalizer, a
  fused-gate ``nn.GRU`` / ``nn.LSTM``, an ``nn.Sequential`` of
  ``nn.Linear`` and activation modules), in fp32 whatever the training
  dtype: the deterministic inference path, ``act_inference``. Its state dict
  has the JAX package's module's keys.
- :func:`export_onnx` runs ``torch.onnx.export`` on it (it needs ``onnx``).
- :func:`export_torch_state_dict` gives the upstream reference's
  ``model_state_dict`` of the whole policy (``actor.<2i>.weight``,
  ``memory_a.rnn.weight_ih_l<k>``, ``actor_obs_normalizer._mean``, ``std`` or
  ``log_std``); :func:`import_torch_state_dict` and
  :func:`import_torch_checkpoint` load such a state dict or ``.pt`` file into
  the port's policy.

The port packs a GRU layer's gates r|z|n as ``wx [D,3H]``, ``bx [3H]``, ``wh
[H,3H]``, ``bhn [H]`` and an LSTM layer's i|f|g|o as ``wx [D,4H]``, ``wh
[H,4H]``, ``bh [4H]`` (``networks/memory.py``, ``utils/weights.py``). torch's
layers hold ``weight_ih = wx^T``, ``weight_hh = wh^T`` and two biases, which
fold into the port's one per gate by addition (exact), except the GRU's n
gate, whose hidden bias sits inside the reset gate's product (``bhn``). So
the export writes zeros where the port has no bias (GRU ``bias_hh`` r and z,
LSTM ``bias_ih``), and the import adds the pairs.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

__all__ = ["as_torch_policy", "export_onnx", "export_torch_state_dict", "import_torch_checkpoint",
           "import_torch_state_dict"]

_ACTIVATION_MODULES = {
    "elu": nn.ELU,
    "selu": nn.SELU,
    "relu": nn.ReLU,
    "crelu": nn.CELU,
    "lrelu": nn.LeakyReLU,
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
    "softplus": nn.Softplus,
    "gelu": lambda: nn.GELU(approximate="tanh"),
    "swish": nn.SiLU,
    "mish": nn.Mish,
    "identity": nn.Identity,
}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).clone()


def _linears(mlp) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """An MLP's ``(weight [out, in], bias)`` pairs in order, fp32 copies."""
    return [(_f32(getattr(mlp, f"dense_{i}").weight), _f32(getattr(mlp, f"dense_{i}").bias))
            for i in range(mlp.num_linear)]


def _torch_gates(cell, rnn_type: str) -> tuple[torch.Tensor, ...]:
    """One packed layer -> torch's ``(weight_ih, bias_ih, weight_hh, bias_hh)``."""
    wx, wh = _f32(cell.wx), _f32(cell.wh)
    if rnn_type == "gru":
        bhn = _f32(cell.bhn)
        zero = torch.zeros(2 * bhn.shape[0], dtype=torch.float32, device=bhn.device)
        return wx.T.contiguous(), _f32(cell.bx), wh.T.contiguous(), torch.cat([zero, bhn])
    bh = _f32(cell.bh)
    return wx.T.contiguous(), torch.zeros_like(bh), wh.T.contiguous(), bh


class _Normalizer(nn.Module):
    """``(x - mean) / (std + eps)`` with frozen moments."""

    def __init__(self, mean: torch.Tensor, std: torch.Tensor, eps: float):
        super().__init__()
        self.register_buffer("mean", mean)
        self.register_buffer("std", std)
        self.eps = eps

    def forward(self, x):
        return (x - self.mean) / (self.std + self.eps)


class TorchPolicy(nn.Module):
    """Deterministic feedforward policy: ``forward(obs [B, obs_dim]) ->
    action [B, A]``, the observation groups of ``obs_names`` concatenated and
    unnormalized."""

    is_recurrent = False

    def __init__(self, normalizer: nn.Module, actor: nn.Sequential, obs_names: list[str]):
        super().__init__()
        self.normalizer = normalizer
        self.actor = actor
        self.obs_names = obs_names

    def forward(self, obs):
        return self.actor(self.normalizer(obs))


class TorchRecurrentPolicy(nn.Module):
    """Deterministic recurrent policy, one step: ``forward(obs [B, obs_dim],
    hidden=None) -> (action [B, A], hidden)`` with torch's hidden layout
    (``[L, B, H]`` for a GRU, ``(h, c)`` for an LSTM; ``None`` is zeros).
    Zeroing an env's batch column of the hidden state resets it."""

    is_recurrent = True

    def __init__(self, normalizer: nn.Module, memory: nn.Module, actor: nn.Sequential, obs_names: list[str]):
        super().__init__()
        self.normalizer = normalizer
        self.memory = memory
        self.actor = actor
        self.obs_names = obs_names
        self.is_lstm = isinstance(memory, nn.LSTM)

    def forward(self, obs, hidden=None):
        out, hidden = self.memory(self.normalizer(obs).unsqueeze(0), hidden)
        return self.actor(out.squeeze(0)), hidden


def _sequential(mlp, trim_output_to: int | None = None) -> nn.Sequential:
    """An MLP as ``nn.Sequential`` (linears at even indices); ``trim_output_to``
    keeps the first outputs of the last linear (the mean half of a
    state-dependent std's ``[2, A]`` head)."""
    linears = _linears(mlp)
    layers: list[nn.Module] = []
    for i, (weight, bias) in enumerate(linears):
        if i == len(linears) - 1 and trim_output_to is not None:
            weight, bias = weight[:trim_output_to], bias[:trim_output_to]
        lin = nn.Linear(weight.shape[1], weight.shape[0], device=weight.device)
        with torch.no_grad():
            lin.weight.copy_(weight)
            lin.bias.copy_(bias)
        layers.append(lin)
        if i < len(linears) - 1:
            layers.append(_ACTIVATION_MODULES[mlp.activation]())
    return nn.Sequential(*layers)


def _rnn(memory, input_size: int) -> nn.Module:
    """A port ``Memory`` as ``nn.GRU`` / ``nn.LSTM`` on its device."""
    cls = nn.GRU if memory.rnn_type == "gru" else nn.LSTM
    device = memory.cell_0.wx.device
    rnn = cls(input_size=input_size, hidden_size=memory.hidden_size, num_layers=memory.num_layers, device=device)
    with torch.no_grad():
        for layer in range(memory.num_layers):
            for name, value in zip(("weight_ih", "bias_ih", "weight_hh", "bias_hh"),
                                   _torch_gates(getattr(memory, f"cell_{layer}"), memory.rnn_type)):
                getattr(rnn, f"{name}_l{layer}").copy_(value)
    return rnn


def as_torch_policy(policy) -> nn.Module:
    """The deterministic inference path of an ``ActorCritic(Recurrent)`` or
    ``StudentTeacher(Recurrent)`` as a standalone fp32 module on the policy's
    device: :class:`TorchPolicy` or :class:`TorchRecurrentPolicy`. The
    normalizer (when configured) runs inside; ``obs_names`` records the
    concatenation order of the observation groups."""
    is_student = hasattr(policy, "student")
    mlp = policy.student if is_student else policy.actor
    norm = policy.norm_student if is_student else policy.norm_actor
    obs_dim = policy.num_student_obs if is_student else policy.num_actor_obs
    trim = policy.num_actions if getattr(policy, "state_dependent_std", False) else None
    actor = _sequential(mlp, trim)
    normalizer = nn.Identity() if norm is None else _Normalizer(_f32(norm.mean), _f32(norm.std), float(norm.eps))
    obs_names = list(policy.obs_groups["policy"])
    if not policy.is_recurrent:
        return TorchPolicy(normalizer, actor, obs_names)
    memory = policy.memory_s if is_student else policy.memory_a
    return TorchRecurrentPolicy(normalizer, _rnn(memory, obs_dim), actor, obs_names)


def export_onnx(policy, path: str, *, batch_size: int = 1, **export_kwargs) -> None:
    """Export :func:`as_torch_policy`'s module to ONNX with
    ``torch.onnx.export``; a recurrent policy exports its hidden state as
    inputs and outputs (``h_in`` / ``h_out``, with ``c_in`` / ``c_out`` for an
    LSTM). Needs the ``onnx`` package, and says so when it is missing."""
    try:
        import onnx  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "export_onnx requires the 'onnx' package (pip install onnx). For an ONNX-free deployment"
            " artifact use utils.export.export_policy (torch.export), or as_torch_policy + torch.save."
        ) from e
    module = as_torch_policy(policy).eval().cpu()
    obs_dim = policy.num_student_obs if hasattr(policy, "student") else policy.num_actor_obs
    obs = torch.zeros(batch_size, obs_dim)

    def _export(args, in_names, out_names):
        kw = dict(input_names=in_names, output_names=out_names, **export_kwargs)
        try:  # torch >= 2.5 needs dynamo=False for the TorchScript exporter
            torch.onnx.export(module, args, path, dynamo=False, **kw)
        except TypeError:
            torch.onnx.export(module, args, path, **kw)

    if not policy.is_recurrent:
        _export((obs,), ["obs"], ["action"])
        return
    h = torch.zeros(policy.rnn_num_layers, batch_size, policy.rnn_hidden_dim)
    if module.is_lstm:
        _export((obs, (h, h.clone())), ["obs", "h_in", "c_in"], ["action", "h_out", "c_out"])
    else:
        _export((obs, h), ["obs", "h_in"], ["action", "h_out"])


# --------------------------------------------------------------------------
# the reference's model_state_dict, out and in
# --------------------------------------------------------------------------


def _parts(policy) -> dict:
    """The policy's pieces under the reference's names: MLPs, memories (with
    their reference prefixes), normalizers (with the port flag that builds
    them) and the std key."""
    if hasattr(policy, "student"):
        mlps = {"student": policy.student, "teacher": policy.teacher}
        memories = {}
        if policy.is_recurrent:
            memories["memory_s.rnn"] = policy.memory_s
            if policy.teacher_recurrent:
                memories["memory_t.rnn"] = policy.memory_t
        norms = {"student_obs_normalizer": (policy.norm_student, "student_obs_normalization"),
                 "teacher_obs_normalizer": (policy.norm_teacher, "teacher_obs_normalization")}
    else:
        mlps = {"actor": policy.actor, "critic": policy.critic}
        memories = {"memory_a.rnn": policy.memory_a, "memory_c.rnn": policy.memory_c} if policy.is_recurrent else {}
        norms = {"actor_obs_normalizer": (policy.norm_actor, "actor_obs_normalization"),
                 "critic_obs_normalizer": (policy.norm_critic, "critic_obs_normalization")}
    std_key = None
    if not getattr(policy, "state_dependent_std", False):
        std_key = "std" if policy.noise_std_type == "scalar" else "log_std"
    return {"mlps": mlps, "memories": memories, "norms": norms, "std": std_key}


def export_torch_state_dict(policy) -> dict[str, torch.Tensor]:
    """The reference's ``model_state_dict`` of the whole policy, CPU fp32
    tensors (a normalizer's ``count`` an int64): actor and critic (or student
    and teacher), memories, the noise std and the normalizers' buffers
    (``_mean`` / ``_var`` / ``_std`` with a leading singleton). The upstream
    modules take it with a strict ``load_state_dict``; it is the inverse of
    :func:`import_torch_state_dict`."""
    parts = _parts(policy)
    sd: dict[str, torch.Tensor] = {}
    for prefix, mlp in parts["mlps"].items():
        for i, (weight, bias) in enumerate(_linears(mlp)):
            sd[f"{prefix}.{2 * i}.weight"] = weight.cpu()
            sd[f"{prefix}.{2 * i}.bias"] = bias.cpu()
    if parts["std"] is not None:
        sd[parts["std"]] = _f32(policy.std).cpu()
    for prefix, memory in parts["memories"].items():
        for layer in range(memory.num_layers):
            for name, value in zip(("weight_ih", "bias_ih", "weight_hh", "bias_hh"),
                                   _torch_gates(getattr(memory, f"cell_{layer}"), memory.rnn_type)):
                sd[f"{prefix}.{name}_l{layer}"] = value.cpu()
    for prefix, (norm, _) in parts["norms"].items():
        if norm is not None:
            var = _f32(norm.var).cpu()
            sd[f"{prefix}._mean"] = _f32(norm.mean).cpu()[None]
            sd[f"{prefix}._var"] = var[None]
            sd[f"{prefix}._std"] = torch.sqrt(var)[None]
            sd[f"{prefix}.count"] = torch.tensor(int(norm.count), dtype=torch.long)
    return sd


def _value(v) -> torch.Tensor:
    """A state-dict value (a tensor or array-like) as a CPU fp32 tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(v, dtype=np.float32))


def _reject_orphan_norm(sd: dict, prefix: str, flag: str) -> None:
    """A checkpoint trained with a normalizer, loaded into a policy built
    without one, would feed raw observations to weights trained on
    normalized ones: refuse it."""
    if f"{prefix}._mean" in sd:
        raise ValueError(
            f"checkpoint contains '{prefix}' statistics but the target policy was built with {flag}=False —"
            " its weights expect normalized observations; enable the flag to import this model"
        )


def _import_std(policy, sd: dict, key: str | None) -> torch.Tensor | None:
    if key is None:
        return None
    if key not in sd:
        raise KeyError(f"checkpoint has no '{key}' parameter — was the reference model built with"
                       f" noise_std_type='{policy.noise_std_type}'?")
    return _value(sd[key])


@torch.no_grad()
def import_torch_state_dict(policy, state_dict: dict) -> None:
    """Load the reference's ``model_state_dict`` into the port's ``policy``,
    in place: MLPs (transposed back into the ``dense_i`` layers), memories
    (torch's gate stacks packed, paired biases folded), normalizer moments
    and the std. The architecture must match: a missing entry raises
    ``KeyError``, a shape mismatch ``ValueError``, before anything is copied.
    A student-teacher policy counts its teacher as loaded afterwards."""
    sd = state_dict
    parts = _parts(policy)
    copies: list[tuple[torch.Tensor, torch.Tensor, str]] = []
    for prefix, mlp in parts["mlps"].items():
        pat = re.compile(rf"^{re.escape(prefix)}\.(\d+)\.weight$")
        idxs = sorted(int(m.group(1)) for k in sd if (m := pat.match(k)))
        if not idxs:
            raise KeyError(f"no '{prefix}.<i>.weight' entries in the state dict")
        if len(idxs) != mlp.num_linear:
            raise ValueError(f"{prefix}: the state dict has {len(idxs)} linear layers, the policy {mlp.num_linear}")
        for i, n in enumerate(idxs):
            layer = getattr(mlp, f"dense_{i}")
            copies += [(layer.weight, _value(sd[f"{prefix}.{n}.weight"]), f"{prefix}.{n}.weight"),
                       (layer.bias, _value(sd[f"{prefix}.{n}.bias"]), f"{prefix}.{n}.bias")]
    std = _import_std(policy, sd, parts["std"])
    if std is not None:
        copies.append((policy.std, std, parts["std"]))
    for prefix, memory in parts["memories"].items():
        H = memory.hidden_size
        for layer in range(memory.num_layers):
            w_ih, b_ih, w_hh, b_hh = (_value(sd[f"{prefix}.{name}_l{layer}"])
                                      for name in ("weight_ih", "bias_ih", "weight_hh", "bias_hh"))
            if memory.rnn_type == "gru":  # r and z fold their biases; n keeps its hidden bias apart
                packed = {"wx": w_ih.T, "bx": torch.cat([b_ih[:2 * H] + b_hh[:2 * H], b_ih[2 * H:]]),
                          "wh": w_hh.T, "bhn": b_hh[2 * H:]}
            else:
                packed = {"wx": w_ih.T, "wh": w_hh.T, "bh": b_ih + b_hh}
            cell = getattr(memory, f"cell_{layer}")
            copies += [(getattr(cell, k), v, f"{prefix}.l{layer}.{k}") for k, v in packed.items()]
    for prefix, (norm, flag) in parts["norms"].items():
        if norm is None:
            _reject_orphan_norm(sd, prefix, flag)
            continue
        for key in ("_mean", "_var", "count"):
            if f"{prefix}.{key}" not in sd:
                raise KeyError(f"checkpoint has no '{prefix}.{key}' — the reference model was saved without this"
                               " observation normalizer; disable the corresponding *_obs_normalization flag to"
                               " import it")
        copies += [(norm.mean, _value(sd[f"{prefix}._mean"]).reshape(norm.mean.shape), f"{prefix}._mean"),
                   (norm.var, _value(sd[f"{prefix}._var"]).reshape(norm.var.shape), f"{prefix}._var"),
                   (norm.count, _value(sd[f"{prefix}.count"]).reshape(()), f"{prefix}.count")]
    mismatched = [f"{name}: expected {tuple(t.shape)}, got {tuple(v.shape)}" for t, v, name in copies
                  if tuple(t.shape) != tuple(v.shape)]
    if mismatched:
        raise ValueError("the state dict does not match the configured policy: " + "; ".join(mismatched[:8]))
    for t, v, _ in copies:
        t.copy_(v.to(t.device))
    if hasattr(policy, "loaded_teacher"):
        policy.loaded_teacher = True


def import_torch_checkpoint(policy, path: str) -> int:
    """Load a reference ``.pt`` checkpoint (``{"model_state_dict", "iter",
    ...}``, read with ``torch.load(weights_only=True)``, no pickled code) into
    ``policy`` with :func:`import_torch_state_dict`; returns the saved
    iteration. The optimizer state is not imported."""
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    import_torch_state_dict(policy, loaded.get("model_state_dict", loaded))
    return int(loaded.get("iter", 0))
