"""The reference's memory is a file a family, ``reference/cells/<rnn_type>.py``,
found by the configuration's ``rnn_type``: a configuration the reference
cannot follow is refused when its cell is loaded, the GRU cell's check goes
through the file, and a new family with a carry of two tensors needs that
file alone. Each case runs in a copy of the benchmark's tree."""

import contextlib
import json
import os
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.check import judge, state_leaves

ROOT = Path(__file__).resolve().parents[2]
CELL = "gru256_fp32.nlink4096.graphed"
CONFIG = "portbench/configs/gru256_fp32.json"
ENVS = 16

COUNTING_GRU = """
import importlib.util

_spec = importlib.util.spec_from_file_location("portbench_real_gru", {real!r})
_real = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_real)
CALLS = dict.fromkeys(("layout", "zeros", "step", "output"), 0)


def _counted(name):
    def call(*args):
        CALLS[name] += 1
        return getattr(_real, name)(*args)
    return call


layout, zeros, step, output = (_counted(name) for name in CALLS)
"""

#: a plain fp32 LSTM in the port's leaves (gates i|f|g|o) and carry order ``(c, h)``
FP32_LSTM = """
import math

import torch


def layout(input_dim, H):
    b = 1.0 / math.sqrt(H)
    return [("wx", (input_dim, 4 * H), b), ("wh", (H, 4 * H), b), ("bh", (4 * H,), b)]


def zeros(N, H, device):
    return torch.zeros(N, H, device=device), torch.zeros(N, H, device=device)


def step(P, carry, x, dtype, op):
    assert dtype is None
    c, h = carry
    H = P["wh"].shape[0]
    a = torch.matmul(x, P["wx"]) + torch.matmul(h, P["wh"]) + P["bh"]
    i, f, o = (torch.sigmoid(a[..., k * H:(k + 1) * H]) for k in (0, 1, 3))
    c = f * c + i * torch.tanh(a[..., 2 * H:3 * H])
    return c, o * torch.tanh(c)


def output(carry):
    return carry[1]
"""


def _copy_tree(tmp_path: Path, **policy) -> Path:
    """The benchmark's tree under ``tmp_path``, the GRU configuration's
    policy updated with ``policy``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((ROOT / CONFIG).read_text())
    config["train_cfg"]["policy"].update(policy)
    (tmp_path / CONFIG).write_text(json.dumps(config))
    return tmp_path


def _spec(root: Path = ROOT) -> dict:
    spec = harness.load_spec(CELL, root)
    spec["mix"]["warmup_iterations"] = 1
    return spec


def _program_steps(spec, seed, weights):
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        program = harness.Program(spec, seed, "cpu", ENVS, weights)
        return program.check_steps(spec["mix"]["init_at_random_ep_len"])


@pytest.mark.parametrize("policy, reason", [
    ({"rnn_type": "lstm"}, "reference/cells/lstm.py"),
    ({"rnn_type": "LSTM"}, "reference/cells/lstm.py"),
    ({"dtype": "bfloat16"}, "fp32 only.*bf16"),
    ({"rnn_num_layers": 2}, "rnn_num_layers 2"),
], ids=["lstm_without_its_file", "rnn_type_lowered", "bf16_gru", "stacked_memories"])
def test_a_memory_the_reference_cannot_follow_is_refused(tmp_path, policy, reason):
    root = _copy_tree(tmp_path, **policy)
    with pytest.raises(harness.SpecError, match=reason):
        harness.load_spec(CELL, root)


def test_a_feedforward_policy_has_no_memory():
    assert harness.load_spec("ff256x3_bf16.nlink4096.graphed")["memory"] is None


def test_the_gru_check_goes_through_its_file(tmp_path):
    root = _copy_tree(tmp_path)
    real = ROOT / "portbench" / "reference" / "cells" / "gru.py"
    (root / "portbench" / "reference" / "cells" / "gru.py").write_text(COUNTING_GRU.format(real=str(real)))
    seed = 2**31 + 23
    counted, spec = _spec(root), _spec()
    weights, _, _ = harness.make_cell_weights(counted, seed, "cpu")
    plain, _, _ = harness.make_cell_weights(spec, seed, "cpu")
    assert list(weights) == list(plain) and all(torch.equal(weights[k], plain[k]) for k in plain)
    steps = _program_steps(spec, seed, weights)
    calls = dict(counted["memory"].CALLS)
    numbers = harness.check_numbers(counted, seed, "cpu", ENVS, weights, steps)
    assert numbers == harness.check_numbers(spec, seed, "cpu", ENVS, weights, steps)
    T, rounds = spec["config"]["train_cfg"]["num_steps_per_env"], harness.CHECK_STEPS
    alg = spec["config"]["train_cfg"]["algorithm"]
    replays = alg["num_learning_epochs"] * alg["num_mini_batches"]
    # each checked step: both memories a collected step, the bootstrap, both replayed a minibatch
    assert counted["memory"].CALLS["step"] - calls["step"] == rounds * (2 * T + 1 + 2 * T * replays)
    assert counted["memory"].CALLS["zeros"] - calls["zeros"] == 2
    assert counted["memory"].CALLS["output"] - calls["output"] == counted["memory"].CALLS["step"] - calls["step"]


def test_a_new_family_needs_only_its_file(tmp_path):
    """A plain fp32 LSTM put in ``cells/lstm.py`` follows the port's LSTM
    policy on the CPU: its ``(c, h)`` carry goes through the collection,
    the replay, the snapshots and the check leaf by leaf."""
    root = _copy_tree(tmp_path, rnn_type="lstm")
    (root / "portbench" / "reference" / "cells" / "lstm.py").write_text(FP32_LSTM)
    spec = _spec(root)
    seed = 2**31 + 29
    weights, _, _ = harness.make_cell_weights(spec, seed, "cpu")
    assert {k for k in weights if k.startswith("memory_a.")} == {f"memory_a.cell_0.{k}" for k in ("wx", "wh", "bh")}
    steps = _program_steps(spec, seed, weights)
    carry = steps[0][1]["carry"]
    assert isinstance(carry["actor"], tuple) and len(carry["actor"]) == 2
    assert {"carry.actor.0", "carry.actor.1", "carry.critic.0", "carry.critic.1"} <= set(state_leaves(steps[0][1]))
    numbers = harness.check_numbers(spec, seed, "cpu", ENVS, weights, steps)
    assert judge(numbers, spec["limits"]), numbers
    assert numbers["loss_gap"] < 1e-5 and numbers["state_gap"] < 1e-5, numbers


def _state(carry):
    zero = torch.zeros(2)
    return {"env": {"theta": zero, "omega": zero, "episode_length": zero}, "obs": zero,
            "norms": {"actor": [zero, zero, zero]}, "carry": carry}


def test_state_leaves_flatten_a_carry_tree():
    c, h = torch.zeros(2, 3), torch.ones(2, 3)
    leaves = state_leaves(_state({"actor": (c, h), "critic": h}))
    assert leaves["carry.actor.0"] is c and leaves["carry.actor.1"] is h and leaves["carry.critic"] is h
    assert "carry.actor" not in leaves
    assert not any(k.startswith("carry.") for k in state_leaves(_state(None)))
