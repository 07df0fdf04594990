"""The numbers that decide ``correct``: the compared side's first training
steps against the plain reference's, step by step.

The reference takes the first step from the start (the weights and the env
reset of the seed, as the compared side) and each later step from the state
the compared side reached before it: the adaptive-KL learning rate changes
by 1.5x where a minibatch's KL crosses a threshold, so two sound runs whose
roundings differ part ways within a few steps, and a comparison over several
free-running steps could not tell them from a fault. Each number is the
largest over the checked steps:

- ``loss_gap``: the relative gap of the step's PPO objective (the update's
  mean surrogate + value coefficient x value loss - entropy coefficient x
  entropy).
- ``grad_gap``: the gradients as the optimizer got them, Adam's first moment
  after the step; by the worst leaf, the gap between the two sides' norms
  against the reference's norm of that leaf or of the median leaf, whichever
  is larger.
- ``change_gap``: the parameters' change over the step, measured as
  ``grad_gap``; leaves whose reference gradient is under a thousandth of the
  median leaf's (nought to rounding, moved by Adam's round-off alone) are
  left out. A step that leaves its parameters unchanged reads 1.
- ``state_gap``: the state the step hands on (env state, obs, every leaf
  of the memories' carry, the normalizers' moments): by the worst leaf, the
  norm of the two sides' difference against the reference's norm of that
  leaf.
"""

from __future__ import annotations

import statistics

import torch

#: a leaf counts in ``change_gap`` where its reference gradient norm is at
#: least this share of the median leaf's
MOVED_SHARE = 1e-3


def objective(losses: dict, alg: dict) -> float:
    return losses["surrogate"] + alg["value_loss_coef"] * losses["value_function"] - alg["entropy_coef"] * losses["entropy"]


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(side: dict, reference: dict, names) -> dict[str, float]:
    """Each leaf's ``| |s| - |r| | / max(|r|, median |r|)``."""
    norms = {k: (_norm(side[k]), _norm(reference[k])) for k in names}
    median = statistics.median(r for _, r in norms.values())
    return {k: abs(s - r) / max(r, median) for k, (s, r) in norms.items()}


def state_leaves(state: dict) -> dict:
    """The state's tensors by name; a memory's carry is ``carry.<which>``
    where it is one tensor, ``carry.<which>.<i>`` for the ``i``-th of a tuple."""
    out = {"env.theta": state["env"]["theta"], "env.omega": state["env"]["omega"],
           "env.episode_length": state["env"]["episode_length"], "obs": state["obs"]}
    for which, (mean, var, _) in state["norms"].items():
        out[f"norm.{which}.mean"], out[f"norm.{which}.var"] = mean, var
    for which, carry in (state["carry"] or {}).items():
        _carry_leaves(f"carry.{which}", carry, out)
    return out


def _carry_leaves(name: str, carry, out: dict) -> None:
    if isinstance(carry, torch.Tensor):
        out[name] = carry
        return
    for i, c in enumerate(carry):
        _carry_leaves(f"{name}.{i}", c, out)


def state_gap(side: dict, reference: dict) -> float:
    a, b = state_leaves(side), state_leaves(reference)
    return max(_norm(a[k].double() - b[k].double()) / max(_norm(b[k]), 1e-30) for k in b)


def compare(side: list, reference: list, start: dict, alg: dict) -> dict[str, float]:
    """The numbers of ``side``'s checked steps ``[(losses, state)]`` against
    the reference's (:func:`portbench.harness.follow`), ``start`` the weights
    both began from; ``worst_leaf`` names the leaf that set ``grad_gap`` and
    ``change_gap``."""
    out = dict.fromkeys(("loss_gap", "grad_gap", "change_gap", "state_gap"), 0.0)
    out["worst_leaf"] = {}
    before = start
    for (s_loss, s_state), (r_loss, r_state) in zip(side, reference):
        grads = {k: _norm(v) for k, v in r_state["mu"].items()}
        median = statistics.median(grads.values())
        moved = [k for k, g in grads.items() if g >= MOVED_SHARE * median]
        change = [{k: st["params"][k] - before[k] for k in moved} for st in (s_state, r_state)]
        r_obj = objective(r_loss, alg)
        out["loss_gap"] = max(out["loss_gap"], abs(objective(s_loss, alg) - r_obj) / abs(r_obj))
        for name, gaps in (("grad_gap", leaf_gaps(s_state["mu"], r_state["mu"], list(grads))),
                           ("change_gap", leaf_gaps(*change, moved))):
            leaf = max(gaps, key=gaps.get)
            if gaps[leaf] >= out[name]:
                out[name], out["worst_leaf"][name] = gaps[leaf], leaf
        out["state_gap"] = max(out["state_gap"], state_gap(s_state, r_state))
        before = s_state["params"]
    return out


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number with a limit is finite and under it."""
    return all(name in numbers and numbers[name] == numbers[name] and numbers[name] <= limit
               for name, limit in limits.items())
