"""The reader of ``env_kernel_share``: the median over the window of each
iteration's step-kernel launches over its env steps, from the tracer's
records; nothing from a program whose records count no kernel or lack part
of the window; 0 on the CPU, where the plain step runs."""

import time
import types
from collections import deque

import pytest

from portbench import harness
from rsl_rl_tpu_torch.utils import trace

WARMUP, WINDOW = 8, 5
FIRST = harness.CHECK_STEPS + WARMUP


def _ctx(iterations=WINDOW):
    return types.SimpleNamespace(spec={"mix": {"warmup_iterations": WARMUP}}, iterations=iterations)


def _record(index: int, steps: int, launches: int | None) -> trace.Record:
    r = trace.Record(iteration=0, index=index)
    for _ in range(steps):
        r.add("env", 0.01, "collect", "stamp")
    if launches:
        r.counts["env.kernel"] = launches
    return r


def _ring(monkeypatch, launches):
    """The window's iterations with 24 env steps each and ``launches[i]``
    kernel launches, and iterations around it that launched none."""
    records = [_record(i, 24, 0) for i in range(FIRST)]
    records += [_record(FIRST + i, 24, n) for i, n in enumerate(launches)]
    records += [_record(FIRST + len(launches) + i, 24, 0) for i in range(3)]
    monkeypatch.setattr(trace, "records", deque(records))
    return records


def test_share_is_the_window_median(monkeypatch):
    _ring(monkeypatch, [24, 24, 12, 24, 0])
    assert harness.load_reader("env_kernel_share")(_ctx()) == pytest.approx(100.0)
    _ring(monkeypatch, [6, 12, 12, 24, 0])
    assert harness.load_reader("env_kernel_share")(_ctx()) == pytest.approx(50.0)


def test_a_program_whose_records_count_nothing_gives_nothing(monkeypatch):
    records = _ring(monkeypatch, [24] * WINDOW)
    assert harness.load_reader("env_kernel_share")(_ctx(iterations=WINDOW + 20)) is None
    spans_only = [types.SimpleNamespace(index=r.index, spans=r.spans) for r in records]
    monkeypatch.setattr(trace, "records", deque(spans_only))
    assert harness.load_reader("env_kernel_share")(_ctx()) is None


def test_a_window_without_env_steps_gives_nothing(monkeypatch):
    records = _ring(monkeypatch, [24] * WINDOW)
    records[FIRST + 1].spans.clear()
    assert harness.load_reader("env_kernel_share")(_ctx()) is None


def test_a_traced_cpu_run_reads_no_kernel():
    """The headline cell at 16 envs on the CPU: the plain step runs, so the
    share reads 0."""
    spec = harness.load_spec("ff256x3_bf16.nlink4096.graphed")
    assert "env_kernel_share" in [m["name"] for m in spec["per_layer"]]
    spec["mix"]["warmup_iterations"] = 1
    spec["mix"]["trace_iterations"] = 1
    out = harness.run_rank(spec, 2**31 + 11, 0.01, True, "cpu", time.perf_counter(), num_envs=16)
    result, _ = harness.result(spec, [out], True, "cpu")
    assert result["metrics"]["env_kernel_share"]["value"] == 0.0
