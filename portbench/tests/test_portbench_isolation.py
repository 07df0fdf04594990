"""Nothing a run imports is JAX, the JAX package or the JAX package's
benchmarks (top-level names compared whole: the port's name begins with the
JAX package's), the plain reference imports nothing of the port, and a run
without a card, or without the port beside the benchmark, fails."""

import ast
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "rsl_rl_tpu", "benchmarks"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")))
def test_sources_import_no_jax(path):
    found = _imports(BENCH / path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    if path.startswith("reference/"):
        assert harness.PROGRAM not in found


RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import harness, calibrate, run
spec = harness.load_spec({cell!r})
spec["mix"]["warmup_iterations"] = 1
harness.run_rank(spec, 3, 0.01, False, "cpu", time.perf_counter(), num_envs=8)
files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values())]
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                   "benchmarks": [f for f in files if "/benchmarks/" in f],
                   "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("cell", ["gru256_fp32.nlink4096.graphed", "ff256x3_bf16.nlink4096.graphed"])
def test_a_run_loads_no_jax(cell):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", RUN.format(root=str(ROOT), cell=cell)], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == [] and seen["benchmarks"] == []
    assert harness.PROGRAM in seen["tops"] and not FORBIDDEN & set(seen["tops"])


def test_a_run_without_a_card_fails_and_prints_nothing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gru256_fp32.nlink4096.graphed",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA device" in proc.stderr


def test_the_port_must_be_beside_the_benchmark(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    (tmp_path / "portbench").mkdir()
    with pytest.raises((harness.SpecError, ModuleNotFoundError)):
        harness.import_program(tmp_path)


class _Queue(list):
    put = list.append


def test_a_rank_that_holds_jax_fails_the_run(monkeypatch, capsys):
    """A rank > 0 reports the forbidden modules of its own process, and the
    run exits without a result if any rank holds one."""
    from portbench import run

    cell = "ff256x3_bf16.dp4_nlink4096.graphed"
    monkeypatch.setattr(harness, "run_rank", lambda *args, **kwargs: {"rank_readings": True})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    queue = _Queue()
    run._rank_worker(2, (cell, 7, 1.0, False, {"backend": "nccl"}), queue)
    monkeypatch.delitem(sys.modules, "jax")
    (rank, readings), = queue
    assert rank == 2 and readings["forbidden"] == ["jax"] and readings["rank_readings"]

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "run_ranks", lambda spec, args: [{}, {"forbidden": []}, readings, {"forbidden": []}])
    code = run.main(["--workload", cell, "--seed", "7", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code == 4 and out.out == "" and "jax" in out.err
