"""The port's examples run on the CPU, each in a subprocess with tiny
arguments and a temporary log dir, as ``tests/test_examples.py`` runs the
JAX package's: ``train_mujoco_host_torch.py`` (where ``mujoco`` is present)
and ``play_torch.py`` on a checkpoint of ``train_pendulum_torch.py``, with
``--export``."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600


def run_example(script: str, *args: str):
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args], capture_output=True,
                          text=True, timeout=TIMEOUT_S, cwd=REPO)


def assert_ok(res, *needles: str):
    assert res.returncode == 0, f"rc={res.returncode}\nstdout:\n{res.stdout[-3000:]}\nstderr:\n{res.stderr[-3000:]}"
    for needle in needles:
        assert needle in res.stdout, res.stdout[-3000:]


@pytest.mark.skipif(importlib.util.find_spec("mujoco") is None, reason="needs the mujoco package")
def test_train_mujoco_host_torch(tmp_path):
    res = run_example("train_mujoco_host_torch.py", "--device", "cpu", "--num-envs", "8", "--iterations", "2",
                      "--num-links", "3", "--log-dir", str(tmp_path))
    assert_ok(res, "Trained on real MuJoCo: 2 iterations x 8 envs")
    assert (tmp_path / "model_1.pt").exists()


def test_play_torch_with_export(tmp_path):
    log_dir = tmp_path / "run"
    assert_ok(run_example("train_pendulum_torch.py", "--device", "cpu", "--num-envs", "8", "--iterations", "2",
                          "--log-dir", str(log_dir)))
    export = tmp_path / "policy.pt2"
    res = run_example("play_torch.py", "--ckpt", str(log_dir / "model_1.pt"), "--device", "cpu", "--num-envs", "4",
                      "--steps", "210", "--export", str(export))
    assert_ok(res, "policy : 4 episodes", "random : 4 episodes", f"exported the deterministic policy to {export}")
    from rsl_rl_tpu_torch.utils.export import load_policy

    policy = load_policy(str(export))
    action = policy({"policy": torch.zeros(4, 3)})
    assert action.shape == (4, 1) and np.isfinite(action.numpy()).all() and not policy.is_recurrent
