"""The port's tracer (``rsl_rl_tpu_torch/utils/trace.py``): one record an
iteration with its phases from the runner's stamps, split and fused and at
K=2; the memory replays' ``memory`` span in the update, paired marks around
each of a minibatch's three replay calls; the host spans under a profiler, nested iteration -> phase, and no
``record_function`` without one; the collector's pauses; the host-env
window's phases; the collectives booked to the side of the iteration they
ran on; the stamps riding in the fused iteration's metrics bit for bit.

On the CPU the stamps read the host clock, so the checks are of structure
and arithmetic, not of the device's time. The file imports no JAX; its
tests marked ``cuda`` hold the stamp kernel and a graphed run's stamps on the
card (``python -m pytest --noconftest -p no:cacheprovider -q -m cuda
tests/test_torch_port_trace.py``).
"""

import gc

import pytest
import torch
import torch.distributed as dist

from rsl_rl_tpu_torch.env import NLinkPendulum
from rsl_rl_tpu_torch.parallel.mesh import Mesh
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from rsl_rl_tpu_torch.utils import trace
from rsl_rl_tpu_torch.utils.cuda_graph import IterationGraph

N, LINKS, T = 8, 3, 4
EPOCHS, MINIBATCHES = 2, 2
#: replay calls a recurrent update makes (forward, backward, weight
#: gradient a minibatch), each between a pair of ``memory`` marks
REPLAYS = 3 * EPOCHS * MINIBATCHES
#: labels of the spans the program emits as ``record_function`` ranges
PROGRAM_LABELS = {"iteration", "alg.collect", "alg.update", "dispatch.replay", "dispatch.read_metrics",
                  "runner.log", "gc"}
MODES = {"split": {}, "fused": {"fuse_iteration": True}, "k2": {"iterations_per_dispatch": 2}}


def _cfg(recurrent: bool, rnn_type: str = "gru", **keys) -> dict:
    policy = {"class_name": "ActorCriticRecurrent" if recurrent else "ActorCritic",
              "actor_hidden_dims": [16], "critic_hidden_dims": [16],
              "actor_obs_normalization": True, "critic_obs_normalization": True}
    if recurrent:
        policy.update(rnn_type=rnn_type, rnn_hidden_dim=8)
    return {"num_steps_per_env": T, "seed": 3, "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
            "policy": policy,
            "algorithm": {"class_name": "PPO", "num_learning_epochs": EPOCHS, "num_mini_batches": MINIBATCHES},
            **keys}


def _runner(mode: str = "split", recurrent: bool = False, device: str = "cpu",
            rnn_type: str = "gru") -> OnPolicyRunner:
    env = NLinkPendulum(N, LINKS, max_episode_length=6, device=device)
    return OnPolicyRunner(env, _cfg(recurrent, rnn_type, **MODES[mode]), device=device)


def _marks(recurrent: bool) -> int:
    """Marks an iteration places: its three, a pair a step around ``env.step``
    and, recurrent, a pair around each replay call of the update."""
    return 2 * T + 3 + (2 * REPLAYS if recurrent else 0)


def _records(*iterations: int) -> list:
    """The ring's newest records, which must be the runner's ``iterations``
    in order, one after another in the process."""
    out = list(trace.records)[-len(iterations):]
    assert [r.iteration for r in out] == list(iterations)
    assert [r.index for r in out] == list(range(out[0].index, out[0].index + len(out)))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("recurrent", [False, True], ids=["feedforward", "recurrent"])
def test_one_record_an_iteration_with_every_phase(mode, recurrent):
    runner = _runner(mode, recurrent)
    runner.learn(3)
    host = {"alg.collect", "alg.update"} if mode == "split" else {"dispatch.replay"}
    if mode == "fused":  # at K=2 a group's last iteration holds the read
        host.add("dispatch.read_metrics")
    for r in _records(0, 1, 2):
        assert {"iteration", "collect", "update", "env", "runner.log"} | host <= set(r.spans)
        assert r.spans["env"].count == T and r.spans["env"].parent == "collect"
        assert r.spans["collect"].parent == r.spans["update"].parent == "iteration"
        assert r.spans["iteration"].parent is None and r.spans["iteration"].clock == "stamp"
        assert 0 < r.ms("env") <= r.ms("collect")
        assert r.ms("collect") + r.ms("update") == pytest.approx(r.ms("iteration"), rel=1e-9)
        assert r.ms("iteration") == pytest.approx((r.last_ns - r.first_ns) * 1e-6)
        assert r.clock == "cpu" and "exchange.collect" not in r.spans
        assert r.marks == _marks(recurrent) and r.ordered
    later = _records(0, 1, 2)[1:]
    assert all(r.gap_ms is not None and r.gap_ms >= 0 for r in later)


def test_k2_gives_each_iteration_its_own_stamps():
    runner = _runner("k2")
    runner.learn(4)
    records = _records(0, 1, 2, 3)
    for a, b in zip(records[:-1], records[1:]):
        assert a.last_ns <= b.first_ns
        assert b.gap_ms == pytest.approx((b.first_ns - a.last_ns) * 1e-6)
    # a group's two replays, one read of their metrics
    assert [r.spans["dispatch.replay"].count for r in records] == [1, 1, 1, 1]
    assert ["dispatch.read_metrics" in r.spans for r in records] == [False, True, False, True]
    assert len({r.first_ns for r in records}) == 4


def _check_memory_marks(labels: list) -> None:
    """The ``memory`` marks come in begin / end pairs with nothing between
    the two of a pair, all after the collection's end."""
    collect_end = labels.index(("collect", trace.END))
    memory = [i for i, (name, _) in enumerate(labels) if name == "memory"]
    assert len(memory) == 2 * REPLAYS and memory[0] > collect_end
    for begin, end in zip(memory[::2], memory[1::2]):
        assert labels[begin] == ("memory", trace.BEGIN) and labels[end] == ("memory", trace.END)
        assert end == begin + 1


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_a_recurrent_update_books_its_replays_as_memory(mode, rnn_type):
    runner = _runner(mode, True, rnn_type=rnn_type)
    runner.learn(2)
    for r in _records(0, 1):
        span = r.spans["memory"]
        assert span.parent == "update" and span.clock == "stamp" and span.count == REPLAYS
        assert 0 < r.ms("memory") <= r.ms("update")
        assert r.marks == _marks(True) and r.ordered
    if mode == "fused":
        _check_memory_marks(runner.iteration_graph.stamp_labels)


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_a_feedforward_update_books_no_memory(mode):
    runner = _runner(mode)
    runner.learn(2)
    assert all("memory" not in r.spans and r.marks == _marks(False) for r in _records(0, 1))


def test_replays_outside_an_iteration_place_no_marks():
    from rsl_rl_tpu_torch.ops.lstm_rnn import lstm_sequence_pair

    H, B, D = 4, 3, 5
    params = {"wx": torch.randn(D, 4 * H, requires_grad=True), "wh": torch.randn(H, 4 * H), "bh": torch.randn(4 * H)}
    carry = (torch.zeros(B, H), torch.zeros(B, H))
    xs = torch.randn(T, B, D)
    hs_a, hs_b = lstm_sequence_pair((params, params), (carry, carry), (xs, xs), torch.zeros(T, B))
    (hs_a.sum() + hs_b.sum()).backward()
    assert trace.take_stamps() is None and params["wx"].grad is not None


def _events(prof) -> list:
    return [e for e in prof.events() if e.name in PROGRAM_LABELS]


def _ancestors(event) -> list[str]:
    names, parent = [], event.cpu_parent
    while parent is not None:
        names.append(parent.name)
        parent = parent.cpu_parent
    return names


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_profiler_sees_the_spans_nested_iteration_then_phase(mode):
    runner = _runner(mode)
    runner.learn(1)  # the fused run's warm-up outside the profile
    gc_in_update = runner.alg.update

    def update(*args, **kwargs):
        gc.collect()
        return gc_in_update(*args, **kwargs)

    runner.alg.update = update
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner.learn(2)
    events = _events(prof)
    names = {e.name for e in events}
    phases = {"alg.collect", "alg.update"} if mode == "split" else {"dispatch.replay", "dispatch.read_metrics"}
    assert phases | {"iteration", "runner.log"} <= names
    assert sum(e.name == "iteration" for e in events) == 2
    for e in events:
        if e.name != "iteration":
            assert "iteration" in _ancestors(e), e.name
    assert "gc" in names
    assert trace.records[-1].spans["runner.log"].count == 1


def test_without_a_profiler_no_record_function_is_entered(monkeypatch):
    entered = []
    enter = torch.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch.profiler.record_function, "__enter__", counting)
    for mode in ("split", "k2"):
        _runner(mode).learn(2)
    assert entered == []


def test_a_forced_collection_is_booked_to_the_running_iteration():
    runner = _runner()
    runner.learn(1)
    log = runner._log

    def collecting_log(it, *args, **kwargs):
        if it == 1:
            gc.collect()
        return log(it, *args, **kwargs)

    runner._log = collecting_log
    automatic = gc.isenabled()
    gc.disable()  # only the forced collection runs
    try:
        runner.learn(2)
    finally:
        if automatic:
            gc.enable()
    first, second = _records(0, 1)  # a new learn starts again from the last iteration
    assert trace.current() is None  # after the loop, pauses go to no record
    gc.collect()
    assert "gc" not in first.spans
    assert second.spans["gc"].count == 1 and second.ms("gc") > 0
    assert second.spans["gc"].parent == "iteration"


def test_host_env_window_phases_are_in_the_records():
    from tests.torch_port_host_env_double import ShardableHostEnv

    cfg = _cfg(False)
    runner = OnPolicyRunner(ShardableHostEnv(N), cfg, device="cpu")
    runner.learn(2)
    for r in _records(0, 1):
        for phase in ("act", "to_host", "env_step", "to_device", "process"):
            assert r.spans[phase].count == T and r.spans[phase].parent == "collect", phase
        assert r.spans["act"].clock == r.spans["process"].clock == "stamp"
        assert r.spans["env_step"].clock == "host"
        assert r.ms("act") + r.ms("process") <= r.ms("collect")


def test_collectives_are_booked_to_their_side_of_the_iteration(monkeypatch):
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: t)
    monkeypatch.setattr(dist, "broadcast", lambda t, src=0, group=None: t)
    monkeypatch.setattr(dist, "all_gather", lambda parts, t, group=None: [p.copy_(t) for p in parts])
    mesh = Mesh(("data",), 2, 1, 0, data_group=object(), distributed=True)
    t = torch.ones(3)
    mesh.data_sum_(t)  # outside an iteration: no mark
    assert trace.take_stamps() is None
    record = trace.open_iteration(0)
    trace.begin_iteration("cpu")
    mesh.data_sum_(t)
    with trace.interval("env"):
        mesh.data_sum_(t)
    trace.end_collection()
    mesh.data_gather(t, 0)
    mesh.data_broadcast_(t)
    trace.end_iteration()
    stamps = trace.take_stamps()
    trace.book(record, stamps.labels, stamps.read(), stamps.clock)
    trace.focus(None)
    assert len(stamps.labels) == 3 + 2 * 5
    assert record.spans["exchange.collect"].count == 2 and record.spans["exchange.collect"].parent == "collect"
    assert record.spans["exchange.update"].count == 2 and record.spans["exchange.update"].parent == "update"
    assert record.ms("exchange.update") <= record.ms("update")


def test_stamps_ride_in_the_packed_metrics_bit_for_bit(monkeypatch):
    # readings whose 32-bit halves are float32 NaN and denormal patterns
    values = [0x7FC00001_7FC00001, 0x7F800001_00000001, 0xFFFFFFFF_7FFFFFFF - 2**63, 0x00000001_FF800001]
    readings = iter(values)
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(readings))

    def step(tree):
        trace.begin_iteration("cpu")
        with trace.interval("env"):
            pass
        trace.end_iteration()
        return tree, {"loss": tree["x"].sum()}

    graph = IterationGraph(step, torch.device("cpu"))
    graph.load({"x": torch.ones(2)})
    metrics = graph.unpack([graph.run()])
    assert float(metrics[0]["loss"]) == 2.0
    assert graph.stamp_labels == [("iteration", "begin"), ("env", "begin"), ("env", "end"), ("iteration", "end")]
    assert graph.stamps[0].tolist() == values


def test_setup_spans_and_the_launch_counters_live_in_the_tracer():
    from rsl_rl_tpu_torch.ops import gru_rnn
    from rsl_rl_tpu_torch.utils.cuda_graph import launch_counters

    assert all(isinstance(c, trace.LaunchCounts) for c in launch_counters())
    assert isinstance(gru_rnn.launch_counts, trace.LaunchCounts)
    assert isinstance(trace.setup, dict)


@pytest.mark.cuda
def test_stamp_kernel_reads_a_monotonic_device_clock():
    """The stamp kernel on the card: marks in stream order never go back,
    a sleep between two shows, and two back-to-back marks cost little."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trace.begin_iteration("cuda")
    for _ in range(8):
        with trace.interval("env"):
            torch.cuda._sleep(100_000)
    trace.end_iteration()
    stamps = trace.take_stamps()
    ns = stamps.read()
    assert all(b >= a for a, b in zip(ns[:-1], ns[1:]))
    assert all(ns[2 * i + 2] - ns[2 * i + 1] > 10_000 for i in range(8))


@pytest.mark.cuda
@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_graph_replays_book_the_replay_kernels_as_memory_on_the_card(rnn_type):
    """Inside an ``IterationGraph`` replay the kernel wrappers' marks are
    captured with the iteration: each replay books a ``memory`` span of three
    launches a minibatch under ``update``, its marks paired and in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rsl_rl_tpu_torch.utils.cuda_graph import launch_counters

    runner = _runner("fused", recurrent=True, device="cuda", rnn_type=rnn_type)
    runner.learn(1)  # the warm-up and the capture
    before = sum(c.fwd_launches + c.bwd_launches + c.wgrad_launches for c in launch_counters())
    runner.learn(3)
    after = sum(c.fwd_launches + c.bwd_launches + c.wgrad_launches for c in launch_counters())
    assert after - before == 3 * REPLAYS
    _check_memory_marks(runner.iteration_graph.stamp_labels)
    for r in _records(0, 1, 2):
        assert r.clock.startswith("cuda") and r.ordered and r.marks == _marks(True)
        assert r.spans["memory"].count == REPLAYS and r.spans["memory"].parent == "update"
        assert 0 < r.ms("memory") < r.ms("update")


@pytest.mark.cuda
def test_graphed_run_records_monotonic_stamps_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runner = _runner("k2", recurrent=True, device="cuda")
    runner.learn(6)
    records = _records(*range(6))
    for r in records:
        assert r.clock.startswith("cuda") and r.ms("env") <= r.ms("collect")
        assert r.ordered and r.marks == _marks(True)
    for a, b in zip(records[:-1], records[1:]):
        assert a.last_ns <= b.first_ns
