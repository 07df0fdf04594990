"""The plain reference against the port on the CPU at a tiny size, and the
control and the planted faults failing the cells' limits.

On the CPU the port replays its memories through their plain versions; the
card's kernels are held by the benchmark's own runs on the card."""

import contextlib
import os

import pytest
import torch

from portbench import harness
from portbench.check import judge

CELLS = ["gru256_fp32.nlink4096.graphed", "ff256x3_bf16.nlink4096.graphed"]
ENVS = 16


def _spec(cell):
    spec = harness.load_spec(cell)
    spec["mix"]["warmup_iterations"] = 1
    return spec


def _program_steps(spec, seed, weights, device="cpu"):
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        program = harness.Program(spec, seed, device, ENVS, weights)
        return program.check_steps(spec["mix"]["init_at_random_ep_len"])


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_port_on_the_cpu(cell):
    spec = _spec(cell)
    seed = 2**31 + 17
    weights, _, _ = harness.make_cell_weights(spec, seed, "cpu")
    numbers = harness.check_numbers(spec, seed, "cpu", ENVS, weights, _program_steps(spec, seed, weights))
    assert judge(numbers, spec["limits"]), numbers
    assert numbers["loss_gap"] < 1e-6 and numbers["state_gap"] == 0.0


@pytest.mark.parametrize("cell", CELLS[:2])
def test_half_batch_fault_fails_the_limits(cell):
    spec = _spec(cell)
    weights, _, _ = harness.make_cell_weights(spec, 5, "cpu")
    steps = harness.free_run(spec, 5, "cpu", ENVS, weights, half_batch=True)
    numbers = harness.check_numbers(spec, 5, "cpu", ENVS, weights, steps)
    assert not judge(numbers, spec["limits"]), numbers


def test_fp8_control_fails_the_bf16_limits():
    spec = _spec("ff256x3_bf16.nlink4096.graphed")
    weights, _, _ = harness.make_cell_weights(spec, 6, "cpu")
    steps = harness.free_run(spec, 6, "cpu", ENVS, weights, control="fp8")
    numbers = harness.check_numbers(spec, 6, "cpu", ENVS, weights, steps)
    assert not judge(numbers, spec["limits"]), numbers


@pytest.mark.cuda
def test_tf32_control_fails_the_fp32_limits():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card: needs an NVIDIA GPU")
    spec = _spec("gru256_fp32.nlink4096.graphed")
    for seed in (1, 2, 3):
        weights, _, _ = harness.make_cell_weights(spec, seed, "cuda")
        steps = harness.free_run(spec, seed, "cuda", 1024, weights, control="tf32")
        numbers = harness.check_numbers(spec, seed, "cuda", 1024, weights, steps)
        assert not judge(numbers, spec["limits"]), numbers


def test_mesh_witness_sums_the_ranks_shares():
    """The reference with each minibatch's gradients summed over four ranks'
    shares trains as the one-sum reference does, to rounding."""
    spec = _spec("ff256x3_bf16.dp4_nlink4096.graphed")
    weights, _, _ = harness.make_cell_weights(spec, 8, "cpu")
    steps = harness.free_run(spec, 8, "cpu", ENVS, weights, parts=spec["mix"]["ranks"])
    numbers = harness.check_numbers(spec, 8, "cpu", ENVS, weights, steps)
    assert numbers["loss_gap"] < 1e-3 and numbers["change_gap"] < 1.0, numbers
    assert set(numbers["worst_leaf"]) == {"grad_gap", "change_gap"}
