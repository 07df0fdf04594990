"""Policy export for deployment (counterpart of ``rsl_rl_tpu/utils/export.py``).

The JAX package serializes its deterministic inference step as StableHLO
plus parameters; the port exports it with ``torch.export.export`` and saves
the program with ``torch.export.save``, so a runtime without the port's
classes runs it with ``torch.export.load``. The program is one step of
``act_inference`` (the normalizer, the memory's plain ``Memory.step`` for a
recurrent policy, and the actor's mean), at the example's batch size, on the
example's device; the carry is an input and an output.

Usage::

    export_policy(runner.alg.policy, obs, path)
    policy_fn = load_policy(path)   # obs_dict -> action, stateful for RNNs
"""

from __future__ import annotations

import json

import torch
from torch import nn

from rsl_rl_tpu_torch.storage.rollout import tree_map

_META = "rsl_rl_tpu_torch.json"


class _InferenceStep(nn.Module):
    """``policy.act_inference`` as the module that ``torch.export`` traces."""

    def __init__(self, policy):
        super().__init__()
        self.policy = policy

    def forward(self, obs, carry):
        return self.policy.act_inference(obs, carry)


def _layout(tree):
    """A JSON description of a carry: its nesting, and each tensor's shape
    and dtype."""
    if isinstance(tree, dict):
        return {"dict": {k: _layout(v) for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        return {"tuple": [_layout(v) for v in tree]}
    return {"shape": list(tree.shape), "dtype": str(tree.dtype).removeprefix("torch.")}


def _zeros(layout, device):
    """The zero carry of :func:`_layout`'s description."""
    if "dict" in layout:
        return {k: _zeros(v, device) for k, v in layout["dict"].items()}
    if "tuple" in layout:
        return tuple(_zeros(v, device) for v in layout["tuple"])
    return torch.zeros(layout["shape"], dtype=getattr(torch, layout["dtype"]), device=device)


def export_policy(policy, example_obs: dict[str, torch.Tensor], path: str) -> None:
    """Export the deterministic inference step of ``policy`` to ``path``.

    Args:
        policy: An ``ActorCritic(Recurrent)`` or ``StudentTeacher(Recurrent)``.
        example_obs: An obs dict fixing the batch size, the shapes and the
            device of the exported program.
        path: The output file (``torch.export.save``'s format).
    """
    num_envs = next(iter(example_obs.values())).shape[0]
    carry = policy.initial_carry(num_envs)
    with torch.no_grad():
        program = torch.export.export(_InferenceStep(policy).eval(), (dict(example_obs), carry))
    meta = {"is_recurrent": bool(policy.is_recurrent), "num_envs": int(num_envs), "carry": _layout(carry),
            "device": str(next(iter(example_obs.values())).device)}
    torch.export.save(program, path, extra_files={_META: json.dumps(meta)})


def load_policy(path: str):
    """Load an exported policy as a stateful callable ``obs_dict -> action``.

    A recurrent policy keeps its carry between calls; ``.reset(dones)``
    zeroes it where ``dones [N]`` is set, all of it with no argument (as
    ``OnPolicyRunner.get_inference_policy()``'s ``reset``). ``.is_recurrent``
    says which.
    """
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    step = program.module()
    device = torch.device(meta["device"])
    state = {"carry": _zeros(meta["carry"], device)}

    @torch.no_grad()
    def call(obs):
        action, state["carry"] = step(obs, state["carry"])
        return action

    def reset(dones=None):
        if dones is None:
            state["carry"] = _zeros(meta["carry"], device)
        else:
            keep = 1.0 - dones.to(torch.float32)[:, None]
            state["carry"] = tree_map(lambda c: c * keep, state["carry"])

    call.reset = reset
    call.is_recurrent = meta["is_recurrent"]
    return call
