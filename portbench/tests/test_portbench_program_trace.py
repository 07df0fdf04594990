"""The readers of the port's own records (``portbench/program_trace.py`` and
the metrics that use it): each reads a hand-made ring and takes exactly the
window's iterations, by their ordinal in the process; a ring that lacks one
of them, or a program without the tracer, gives nothing; and a traced run on
the CPU at a tiny size prints every such metric of its cell."""

import statistics
import time
import types
from collections import deque

import pytest

from portbench import harness, program_trace
from rsl_rl_tpu_torch.utils import trace

WARMUP, WINDOW = 8, 5
FIRST = harness.CHECK_STEPS + WARMUP
MS_METRICS = {"collect_device_ms": ("collect",), "env_device_ms": ("env",), "update_device_ms": ("update",),
              "exchange_device_ms": ("exchange.collect", "exchange.update")}
RING_METRICS = [*MS_METRICS, "iteration_gap_share", "gc_ms_per_it"]


def _ctx(iterations=WINDOW):
    return types.SimpleNamespace(spec={"mix": {"warmup_iterations": WARMUP}}, iterations=iterations)


def _record(index: int, scale: float) -> trace.Record:
    """The process's iteration ``index``, every one the runner's iteration 0
    (a new ``learn`` starts again from the last), so only the ordinal tells
    them apart; ``scale`` sets its spans, far apart inside the window and out."""
    r = trace.Record(iteration=0, index=index)
    r.first_ns = index * 10_000_000
    r.last_ns = r.first_ns + int(9_000_000 * scale)
    r.gap_ms = 10.0 - 9.0 * scale
    r.clock = "cuda:0"
    for name, ms in (("collect", 3.0), ("env", 1.0), ("update", 6.0), ("exchange.collect", 0.5),
                     ("exchange.update", 0.25), ("gc", 0.125)):
        r.add(name, ms * scale * (1 + index % 3), clock="stamp")
    return r


@pytest.fixture
def ring(monkeypatch):
    records = deque([_record(i, 0.5 if FIRST <= i < FIRST + WINDOW else 50.0) for i in range(FIRST + WINDOW + 4)])
    monkeypatch.setattr(trace, "records", records)
    monkeypatch.setattr(trace, "setup", {"graph.warmup": 2.5, "graph.capture": 1.25})
    return [r for r in records if FIRST <= r.index < FIRST + WINDOW]


@pytest.mark.parametrize("metric", sorted(MS_METRICS))
def test_device_ms_readers_take_the_window_median(ring, metric):
    expected = statistics.median(sum(r.ms(n) for n in MS_METRICS[metric]) for r in ring)
    assert harness.load_reader(metric)(_ctx()) == pytest.approx(expected)


def test_gap_share_is_the_window_gaps_over_its_device_span(ring):
    span_ms = (ring[-1].last_ns - ring[0].first_ns) * 1e-6
    expected = 100.0 * sum(r.gap_ms for r in ring[1:]) / span_ms
    assert harness.load_reader("iteration_gap_share")(_ctx()) == pytest.approx(expected)


def test_gc_reader_is_the_window_pause_an_iteration(ring):
    expected = sum(r.ms("gc") for r in ring) / WINDOW
    assert harness.load_reader("gc_ms_per_it")(_ctx()) == pytest.approx(expected)


def test_warmup_reader_reads_the_setup_span(ring):
    assert harness.load_reader("graph_warmup_s")(_ctx()) == 2.5


@pytest.mark.parametrize("metric", RING_METRICS)
def test_a_ring_without_the_whole_window_gives_nothing(ring, metric, monkeypatch):
    monkeypatch.setattr(trace, "records", deque(r for r in trace.records if r.index != FIRST + 2))
    assert harness.load_reader(metric)(_ctx()) is None
    assert harness.load_reader(metric)(_ctx(iterations=WINDOW + 20)) is None


@pytest.mark.parametrize("metric", [*RING_METRICS, "graph_warmup_s"])
def test_a_program_without_the_tracer_gives_nothing(ring, metric, monkeypatch):
    monkeypatch.setattr(program_trace, "TRACER", "rsl_rl_tpu_torch.utils.no_such_tracer")
    assert harness.load_reader(metric)(_ctx()) is None


def test_unstamped_records_give_no_device_reading(ring):
    for r in trace.records:
        r.first_ns = None
    assert harness.load_reader("collect_device_ms")(_ctx()) is None
    assert harness.load_reader("iteration_gap_share")(_ctx()) is None
    assert harness.load_reader("gc_ms_per_it")(_ctx()) is not None


def test_a_traced_cpu_run_prints_the_program_metrics():
    """The headline cell at 16 envs on the CPU, traced, with a one-iteration
    window: the readers find it in the real ring (host-clock stamps here, no
    device number)."""
    spec = harness.load_spec("ff256x3_bf16.nlink4096.graphed")
    spec["mix"]["warmup_iterations"] = 1
    spec["mix"]["trace_iterations"] = 1
    out = harness.run_rank(spec, 2**31 + 7, 0.01, True, "cpu", time.perf_counter(), num_envs=16)
    result, _ = harness.result(spec, [out], True, "cpu")
    metrics = result["metrics"]
    # a one-iteration window: no gap inside it to share
    for name in ("collect_device_ms", "env_device_ms", "update_device_ms", "gc_ms_per_it"):
        assert name in metrics and metrics[name]["value"] >= 0, name
    assert 0 < metrics["env_device_ms"]["value"] <= metrics["collect_device_ms"]["value"]
    # no capture on the CPU, no mesh in the cell
    assert "graph_warmup_s" not in metrics and "exchange_device_ms" not in metrics
