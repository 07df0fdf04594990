"""The benchmark's LSTM configuration, ``lstm256_bf16``, against its plain
reference on the CPU: the port's ``Memory("lstm")`` (its step and its
replay's plain path, values and gradients) against
``portbench/reference/cells/lstm.py`` in fp32 and with bf16 operands, the
fp8 control reaching the reference's memory, the reference importing
nothing of the port or of JAX, the cell's checked steps ``correct`` at 16
envs (and the control and the planted fault not), and the reader of the
replays' ``memory`` span with the cell's metric lists.

No JAX: the reference and the port are both PyTorch."""

import ast
import contextlib
import os
import statistics
import types
from collections import deque
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.check import judge
from rsl_rl_tpu_torch.networks.memory import Memory
from rsl_rl_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
CELL = "lstm256_bf16.nlink4096.graphed"
REFERENCE = ROOT / "portbench" / "reference" / "cells" / "lstm.py"
N, D, H, T = 16, 15, 32, 6
DTYPES = {"fp32": None, "bf16": torch.bfloat16}
#: fp32 and bf16 alike: both sides round the same operands, so every
#: product is exact in fp32 and only the order of the fp32 sums may differ
#: (the port batches its products): a few ulps of values of order 1 a step,
#: which the window's six steps carry on (0 measured on the CPU)
STEP_ATOL = 2e-6
SEQUENCE_ATOL = 1e-5
#: the replay's gradients, fp32 and bf16 alike: the port's hand-written
#: backward against autograd through the reference's products, the same
#: derivatives of the same rounded operands (in bf16 each backward product
#: rounds its operands too) summed in another order (2.2e-7 measured); an
#: fp32 backward under bf16 operands reads 1.7e-3
GRAD_RTOL = 1e-5


def _identity(t):
    return t


def _fp8(t):
    return t.to(torch.float8_e4m3fn).to(t.dtype)


@pytest.fixture(scope="module")
def reference():
    return harness.load_memory({"class_name": "ActorCriticRecurrent", "rnn_type": "lstm"})


def _weights(reference, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {leaf: (torch.rand(shape, generator=gen) * 2 - 1) * bound for leaf, shape, bound in reference.layout(D, H)}


def _memory(weights: dict, dtype) -> Memory:
    mem = Memory(D, H, "lstm", 1, compute_dtype=dtype)
    with torch.no_grad():
        for leaf, value in weights.items():
            getattr(mem.cell_0, leaf).copy_(value)
    return mem


def _inputs(seed: int):
    gen = torch.Generator().manual_seed(seed)
    xs = torch.randn(T, N, D, generator=gen)
    carry = (torch.randn(N, H, generator=gen), torch.randn(N, H, generator=gen) * 0.5)
    resets = (torch.rand(T, N, generator=gen) < 0.25).float()
    return xs, carry, resets


def _reference_sequence(reference, P, carry, xs, resets, dtype, op=_identity):
    outs = []
    for t in range(xs.shape[0]):
        keep = (1.0 - resets[t])[:, None]
        carry = reference.step(P, tuple(v * keep for v in carry), xs[t], dtype, op)
        outs.append(reference.output(carry))
    return torch.stack(outs)


def test_layout_is_the_ports_leaves_and_order(reference):
    mem = Memory(D, H, "lstm", 1)
    assert [(leaf, shape) for leaf, shape, _ in reference.layout(D, H)] == [
        (name, tuple(p.shape)) for name, p in mem.cell_0.named_parameters()]
    c, h = reference.zeros(N, H, "cpu")
    assert c.shape == h.shape == (N, H) and not c.any() and not h.any()


@pytest.mark.parametrize("precision", sorted(DTYPES))
def test_port_step_follows_the_reference(reference, precision):
    dtype = DTYPES[precision]
    P = _weights(reference, 1)
    xs, carry, _ = _inputs(2)
    (port_carry,), out = _memory(P, dtype).step((carry,), xs[0])
    ref_carry = reference.step(P, carry, xs[0], dtype, _identity)
    torch.testing.assert_close(port_carry[0], ref_carry[0], rtol=0, atol=STEP_ATOL)
    torch.testing.assert_close(port_carry[1], ref_carry[1], rtol=0, atol=STEP_ATOL)
    torch.testing.assert_close(out, reference.output(ref_carry), rtol=0, atol=STEP_ATOL)


@pytest.mark.parametrize("precision", sorted(DTYPES))
def test_port_replay_follows_the_reference_with_resets(reference, precision):
    """The window replay (the plain path of the x-streaming replay on the
    CPU), its carry zeroed where ``resets`` says, and its gradients."""
    dtype = DTYPES[precision]
    P = _weights(reference, 3)
    xs, carry, resets = _inputs(4)
    assert resets.any() and not resets.all()
    mem = _memory(P, dtype)
    xs_port = xs.clone().requires_grad_(True)
    out = mem.sequence((carry,), xs_port, resets)
    ref_P = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    xs_ref = xs.clone().requires_grad_(True)
    ref = _reference_sequence(reference, ref_P, carry, xs_ref, resets, dtype)
    torch.testing.assert_close(out, ref, rtol=0, atol=SEQUENCE_ATOL)

    weight = torch.randn(T, N, H, generator=torch.Generator().manual_seed(5))
    (out * weight).sum().backward()
    (ref * weight).sum().backward()
    pairs = [(getattr(mem.cell_0, k).grad, ref_P[k].grad) for k in P] + [(xs_port.grad, xs_ref.grad)]
    for port_grad, ref_grad in pairs:
        gap = torch.linalg.vector_norm(port_grad - ref_grad) / torch.linalg.vector_norm(ref_grad)
        assert gap < GRAD_RTOL, float(gap)


def test_the_fp8_control_reaches_the_reference_memory(reference):
    """The control's float8 operands move the bf16 memory's replay by far
    more than the port and the reference differ by."""
    P = _weights(reference, 6)
    xs, carry, resets = _inputs(7)
    bf16 = _reference_sequence(reference, P, carry, xs, resets, torch.bfloat16)
    fp8 = _reference_sequence(reference, P, carry, xs, resets, torch.bfloat16, _fp8)
    assert float((fp8 - bf16).abs().max()) > 100 * SEQUENCE_ATOL
    with torch.no_grad():
        port = _memory(P, torch.bfloat16).sequence((carry,), xs, resets)
    assert float((port - bf16).abs().max()) <= SEQUENCE_ATOL


def test_the_reference_refuses_another_dtype(reference):
    P = _weights(reference, 8)
    with pytest.raises(harness.SpecError, match="fp32 or with bf16"):
        reference.step(P, reference.zeros(N, H, "cpu"), torch.zeros(N, D), torch.float16, _identity)


def test_the_reference_imports_nothing_of_the_port_or_jax():
    tops = set()
    for node in ast.walk(ast.parse(REFERENCE.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            tops.add(node.module.split(".")[0])
    assert tops == {"__future__", "math", "torch", "portbench"}
    assert not tops & {"rsl_rl_tpu_torch", "rsl_rl_tpu", "jax", "jaxlib", "flax"}


# --------------------------------------------------------------- the cell

ENVS = 16


def _spec():
    spec = harness.load_spec(CELL)
    spec["mix"]["warmup_iterations"] = 1
    return spec


def _numbers(spec, seed, **free):
    weights, _, _ = harness.make_cell_weights(spec, seed, "cpu")
    if free:
        steps = harness.free_run(spec, seed, "cpu", ENVS, weights, **free)
    else:
        with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
            program = harness.Program(spec, seed, "cpu", ENVS, weights)
            steps = program.check_steps(spec["mix"]["init_at_random_ep_len"])
    return harness.check_numbers(spec, seed, "cpu", ENVS, weights, steps)


def test_the_cell_loads_with_its_memory_and_precision():
    spec = _spec()
    policy = spec["config"]["train_cfg"]["policy"]
    assert spec["memory"].__file__ == str(REFERENCE)
    assert (policy["class_name"], policy["rnn_type"], policy["rnn_hidden_dim"], policy["rnn_num_layers"]) == (
        "ActorCriticRecurrent", "lstm", 256, 1)
    assert policy["dtype"] == "bfloat16" and spec["config"]["precision"] == "bf16"
    assert policy["actor_hidden_dims"] == policy["critic_hidden_dims"] == [256, 256, 256]
    assert spec["mix"]["envs_per_rank"] == 4096 and spec["cell"]["chips"] == 1


def test_the_cells_checked_steps_are_correct_on_the_cpu():
    spec = _spec()
    numbers = _numbers(spec, 2**31 + 41)
    assert judge(numbers, spec["limits"]), numbers
    # the collection's carry follows bit for bit: the same rounded operands
    assert numbers["state_gap"] == 0.0


@pytest.mark.parametrize("free", [{"control": "fp8"}, {"half_batch": True}], ids=["fp8_control", "half_batch"])
def test_the_control_and_the_fault_fail_the_cells_limits(free):
    spec = _spec()
    numbers = _numbers(spec, 2**31 + 43, **free)
    assert not judge(numbers, spec["limits"]), numbers


# ------------------------------------------------------- memory_device_ms

WARMUP, WINDOW = 2, 5
FIRST = harness.CHECK_STEPS + WARMUP


def _ctx():
    return types.SimpleNamespace(spec={"mix": {"warmup_iterations": WARMUP}}, iterations=WINDOW)


def _ring(memory: bool, stamped: bool = True) -> deque:
    """A process's records; the window's ``memory`` spans far from those outside it."""
    out = deque()
    for i in range(FIRST + WINDOW + 3):
        r = trace.Record(iteration=0, index=i)
        inside = FIRST <= i < FIRST + WINDOW
        if stamped:
            r.first_ns, r.last_ns, r.clock = i * 10**8, i * 10**8 + 9 * 10**7, "cuda:0"
        r.add("update", 60.0, clock="stamp")
        if memory:
            for _ in range(60):
                r.add("memory", (0.5 + 0.1 * (i % 3)) * (1 if inside else 40), "update", "stamp")
        out.append(r)
    return out


def test_memory_device_ms_reads_the_stamped_window(monkeypatch):
    ring = _ring(memory=True)
    monkeypatch.setattr(trace, "records", ring)
    window = [r for r in ring if FIRST <= r.index < FIRST + WINDOW]
    expected = statistics.median(r.ms("memory") for r in window)
    assert harness.load_reader("memory_device_ms")(_ctx()) == pytest.approx(expected)


@pytest.mark.parametrize("ring", [{"memory": False}, {"memory": True, "stamped": False}],
                         ids=["no_memory_stamps", "unstamped"])
def test_memory_device_ms_gives_none_without_stamps(monkeypatch, ring):
    monkeypatch.setattr(trace, "records", _ring(**ring))
    assert harness.load_reader("memory_device_ms")(_ctx()) is None


def test_memory_device_ms_gives_none_without_the_tracer(monkeypatch):
    from portbench import program_trace

    monkeypatch.setattr(trace, "records", _ring(memory=True))
    monkeypatch.setattr(program_trace, "TRACER", "rsl_rl_tpu_torch.utils.no_such_tracer")
    assert harness.load_reader("memory_device_ms")(_ctx()) is None


def test_the_cells_metrics_are_those_of_the_recurrent_cells():
    """The new cell reports what the GRU cell reports, the replays' span
    among them, and nothing of the mesh; the feedforward cells do not read
    the replays."""
    names = {cell: {m["name"] for m in harness.load_spec(cell)["per_layer"]}
             for cell in (CELL, "gru256_fp32.nlink4096.graphed", "ff256x3_bf16.nlink4096.graphed")}
    assert names[CELL] == names["gru256_fp32.nlink4096.graphed"]
    assert {"memory_device_ms", "rnn_launches_per_it", "rnn_kernel_roofline", "step_mfu"} <= names[CELL]
    assert not {"nccl_busy_share", "exchange_device_ms"} & names[CELL]
    assert not {"memory_device_ms", "rnn_launches_per_it", "rnn_kernel_roofline"} & names[
        "ff256x3_bf16.nlink4096.graphed"]
    spec = harness.load_spec(CELL)
    assert {m["name"] for m in spec["end_to_end"]} == {"env_steps_per_s", "setup_s"}
    memory = next(m for m in spec["per_layer"] if m["name"] == "memory_device_ms")
    assert (memory["layer"], memory["unit"], memory["moves"]) == ("memory replay", "ms", "env_steps_per_s")
