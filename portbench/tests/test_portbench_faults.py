"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at a tiny size, once sound and once for each fault a training cell on
one chip can have."""

import time

import pytest

from portbench import harness

ENVS = 16


def _run(cell, fault=None):
    spec = harness.load_spec(cell)
    spec["mix"]["warmup_iterations"] = 1
    out = harness.run_rank(spec, 2**31 + 99, 0.01, False, "cpu", time.perf_counter(), num_envs=ENVS, fault=fault)
    result, lines = harness.result(spec, [out], False, "cpu")
    assert len(lines) == len(spec["limits"]) and list(result)[-1] == "checks"
    return result


def _unchanged(program):
    """The step returns its state unchanged: the optimizer never steps."""
    program.runner.alg.optimizer_step = lambda *args, **kwargs: None


def _half_batch(program):
    """Half of each minibatch left out, the mean taken over the rest."""
    alg = program.runner.alg
    loss = alg._loss
    axis = 1 if alg.policy.is_recurrent else 0

    def half(batch, carry0, *args):
        cut = {}
        for k, v in batch.items():
            if isinstance(v, dict):
                cut[k] = {g: t.narrow(axis, 0, t.shape[axis] // 2) for g, t in v.items()}
            else:
                cut[k] = v.narrow(axis, 0, v.shape[axis] // 2)
        if isinstance(carry0, dict):
            carry0 = {k: tuple(h[: h.shape[0] // 2] for h in v) for k, v in carry0.items()}
        return loss(cut, carry0, *args)

    alg._loss = half


@pytest.mark.parametrize("cell", ["gru256_fp32.nlink4096.graphed", "ff256x3_bf16.nlink4096.graphed"])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["gru256_fp32.nlink4096.graphed", "ff256x3_bf16.nlink4096.graphed"])
def test_broken_timed_path_is_not_correct(cell, fault):
    result = _run(cell, fault)
    assert result["correct"] is False, result["checks"]


def test_unchanged_state_reads_about_one():
    result = _run("gru256_fp32.nlink4096.graphed", _unchanged)
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)
