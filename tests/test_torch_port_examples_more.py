"""The port's remaining examples run on the CPU, each in a subprocess with
tiny arguments (``--device cpu``) and a temporary log dir, as
``tests/test_examples.py`` runs the JAX package's: ``train_recurrent_torch.py``
(GRU and LSTM), ``train_domain_randomized_torch.py``,
``train_multiseed_torch.py`` (with the best seed's export),
``train_pbt_torch.py``, ``distill_student_torch.py``,
``distill_privileged_torch.py``, ``export_policy_torch.py`` on a
checkpoint of ``train_pendulum_torch.py`` and ``train_mjx_torch.py``. A
file of its own, so that ``--dist loadfile`` runs these subprocesses beside
``tests/test_torch_port_examples.py``'s."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from tests.test_torch_port_examples import REPO, TIMEOUT_S, assert_ok


def run_example(script: str, *args: str):
    """The example in a subprocess on two CPU threads (the test workers
    share the machine's cores)."""
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args], capture_output=True,
                          text=True, timeout=TIMEOUT_S, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "2"})


@pytest.mark.parametrize("rnn", ["gru", "lstm"])
def test_train_recurrent_torch(tmp_path, rnn):
    res = run_example("train_recurrent_torch.py", "--device", "cpu", "--num-envs", "8", "--iterations", "2",
                      "--rnn", rnn, "--log-dir", str(tmp_path))
    assert_ok(res, "Learning iteration 1/2")
    assert (tmp_path / "model_1.pt").exists()


def test_train_domain_randomized_torch(tmp_path):
    res = run_example("train_domain_randomized_torch.py", "--device", "cpu", "--num-envs", "8", "--iterations", "2",
                      "--num-links", "2", "--log-dir", str(tmp_path))
    assert_ok(res, "Learning iteration 1/2")
    assert (tmp_path / "model_1.pt").exists()


def test_train_multiseed_torch_exports_its_best_seed(tmp_path):
    res = run_example("train_multiseed_torch.py", "--device", "cpu", "--seeds", "2", "--num-envs", "8",
                      "--iterations", "9", "--log-dir", str(tmp_path))
    assert_ok(res, "best seed ")
    best = [p for p in tmp_path.iterdir() if p.name.startswith("best_seed_")]
    assert len(best) == 1
    from rsl_rl_tpu_torch.env import Pendulum
    from rsl_rl_tpu_torch.runners import OnPolicyRunner

    sys.path.insert(0, os.path.join(REPO, "examples"))
    from train_multiseed_torch import train_cfg

    runner = OnPolicyRunner(Pendulum(8, device="cpu"), train_cfg(0), device="cpu")
    runner.load(str(best[0]))


def test_train_pbt_torch():
    res = run_example("train_pbt_torch.py", "--device", "cpu", "--seeds", "4", "--num-envs", "8", "--iterations",
                      "10", "--exploit-interval", "5")
    assert_ok(res, "it    1 | fitness", "it   10 | fitness", "best seed: ")


def test_distill_student_torch(tmp_path):
    res = run_example("distill_student_torch.py", "--device", "cpu", "--num-envs", "8", "--teacher-iterations",
                      "1", "--distill-iterations", "2", "--log-dir", str(tmp_path))
    assert_ok(res, "Learning iteration 1/2")
    assert (tmp_path / "teacher" / "model_0.pt").exists() and (tmp_path / "student" / "model_1.pt").exists()


def test_distill_privileged_torch(tmp_path):
    res = run_example("distill_privileged_torch.py", "--device", "cpu", "--num-envs", "8", "--teacher-iterations",
                      "1", "--distill-iterations", "2", "--log-dir", str(tmp_path))
    assert_ok(res, "Learning iteration 1/2")
    assert (tmp_path / "student" / "model_1.pt").exists()


def test_export_policy_torch(tmp_path):
    log_dir = tmp_path / "run"
    assert_ok(run_example("train_pendulum_torch.py", "--device", "cpu", "--num-envs", "8", "--iterations", "1",
                          "--log-dir", str(log_dir)))
    out = tmp_path / "deploy"
    res = run_example("export_policy_torch.py", "--ckpt", str(log_dir / "model_0.pt"), "--out-dir", str(out),
                      "--device", "cpu")
    assert_ok(res, "policy.pt2 (verified vs live policy)", "policy.pt (torch module verified vs live policy)",
              "reference_state_dict.pt (strict-loads")
    assert "wrote" in res.stdout.splitlines()[-1] or "skipped ONNX" in res.stdout
    from rsl_rl_tpu_torch.utils.export import load_policy

    action = load_policy(str(out / "policy.pt2"))({"policy": torch.zeros(4, 3)})
    assert action.shape == (4, 1) and torch.isfinite(action).all()
    assert "actor.0.weight" in torch.load(out / "reference_state_dict.pt")


def test_train_mjx_torch(tmp_path):
    """Without ``--sim`` the script exits with the adapter's message (no torch
    package provides MJX's functions), as ``examples/train_mjx.py`` does
    without ``mujoco-mjx``; with the torch double of
    ``tests/torch_port_sim_doubles.py`` it trains, reloads its checkpoint and
    evaluates (where ``mujoco`` builds the host model)."""
    res = run_example("train_mjx_torch.py", "--device", "cpu", "--num-envs", "4", "--iterations", "2")
    assert res.returncode != 0
    assert "no torch package provides" in res.stderr, res.stderr[-3000:]
    pytest.importorskip("mujoco")
    res = run_example("train_mjx_torch.py", "--sim", "tests.torch_port_sim_doubles:mjx", "--device", "cpu",
                      "--num-envs", "4", "--iterations", "2", "--log-dir", str(tmp_path))
    assert_ok(res, "Learning iteration 1/2", "deterministic eval return over 200 steps")
    assert (tmp_path / "model_1.pt").exists()
