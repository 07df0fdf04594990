"""The four-rank cell's path on the CPU: four Gloo ranks of the mesh, each
its shard of the envs, graphed as one process is (on the CPU the iteration
runs eagerly), checked against the plain reference over every rank's envs."""

import json
import multiprocessing
import time
from pathlib import Path

import pytest

from portbench import harness

CELL = "ff256x3_bf16.dp4_nlink4096.graphed"
ENVS = 8


def _spec():
    spec = harness.load_spec(CELL)
    spec["mix"]["warmup_iterations"] = 1
    return spec


def _rank(rank, init, queue):
    import torch

    torch.set_num_threads(1)
    out = harness.run_rank(_spec(), 11, 0.01, False, "cpu", time.perf_counter(),
                           mesh_init={**init, "rank": rank}, num_envs=ENVS)
    queue.put((rank, out))


def test_four_gloo_ranks_train_as_one_process(tmp_path: Path):
    ranks = _spec()["mix"]["ranks"]
    init = {"backend": "gloo", "init_method": f"file://{tmp_path / 'rendezvous'}", "world_size": ranks}
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, init, queue)) for r in range(ranks)]
    for p in procs:
        p.start()
    try:
        outs = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    assert outs[0]["envs_global"] == ranks * ENVS
    result, _ = harness.result(_spec(), [outs[r] for r in range(ranks)], False, "cpu")
    assert result["correct"] is True, json.dumps(result["checks"])
    assert result["device"]["count"] == ranks


def test_the_mesh_cell_asks_for_four_chips():
    spec = _spec()
    assert spec["cell"]["chips"] == spec["mix"]["ranks"] == 4
    with pytest.raises(harness.SpecError):
        harness.load_spec("ff256x3_bf16.dp8_nlink4096.graphed")
