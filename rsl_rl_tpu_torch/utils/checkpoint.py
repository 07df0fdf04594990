"""Checkpoint files (counterpart of ``rsl_rl_tpu/utils/checkpoint.py``).

A checkpoint is one torch file holding a dict of plain state: state dicts
of tensors, tensors, numbers, strings, ``None`` and containers of them,
with a ``"format"`` marker. It is written atomically (a temporary file,
then a rename) and read with ``torch.load(weights_only=True)``, so loading
a file can never run code from it. ``latest_checkpoint(log_dir)`` finds the
newest ``model_<it>.pt``, the auto-resume entry point.
"""

from __future__ import annotations

import os
import re

import torch

FORMAT = "rsl_rl_tpu_torch"
_CKPT_RE = re.compile(r"model_(\d+)\.pt$")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: dict) -> None:
    """Write ``state`` (plain data, tensors moved to the CPU) to ``path``
    atomically; errors (disk full, permissions) raise here."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"format": FORMAT, **_to_cpu(state)}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location=None) -> dict:
    """Read a checkpoint written by :func:`save_checkpoint`, its tensors on
    ``map_location`` (as saved, the CPU, by default).

    Raises ``FileNotFoundError`` for a missing path and ``ValueError`` for a
    directory, a file torch cannot read as plain data, or a torch file that
    is not a checkpoint of this package."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"No checkpoint at {path}")
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory, not an {FORMAT} checkpoint file")
    try:
        state = torch.load(path, map_location=map_location, weights_only=True)
    except Exception as e:  # torch raises several types for unreadable files
        raise ValueError(f"Failed to read checkpoint at {path}: {e}") from e
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise ValueError(f"{path} is not an {FORMAT} checkpoint")
    return state


def latest_checkpoint(log_dir: str) -> str | None:
    """Path of the highest-iteration ``model_<it>.pt`` in ``log_dir`` (None
    when there is none or the directory does not exist)."""
    best_it, best_path = -1, None
    try:
        entries = os.listdir(log_dir)
    except FileNotFoundError:
        return None
    for name in entries:
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_it:
            best_it, best_path = int(m.group(1)), os.path.join(log_dir, name)
    return best_path
