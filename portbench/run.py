"""Run one cell of the port's benchmark and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs as many CUDA devices as the cell's chips; without them it exits with
code 3 and prints no result. A cell of several ranks runs one process a
card (this process is rank 0), an NCCL group rendezvousing through a file
under the temporary directory. The check's numbers, each beside its limit,
are the last lines on standard error and the ``checks`` key of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: seconds a rank of a multi-card cell may take beyond rank 0's run
JOIN_TIMEOUT_S = 120


def _rank_worker(rank: int, args: tuple, queue) -> None:
    """A rank > 0 of a multi-card cell: its readings, with the forbidden
    modules its own process holds once its window has closed, go to rank 0
    by ``queue``."""
    t_start = time.perf_counter()
    from portbench import harness

    workload, seed, seconds, trace, init = args
    spec = harness.load_spec(workload)
    import torch

    out = harness.run_rank(spec, seed, seconds, trace, f"cuda:{rank}", t_start,
                           mesh_init={**init, "rank": rank, "device_id": torch.device("cuda", rank)})
    queue.put((rank, {**out, "forbidden": harness.forbidden_modules()}))


def run_ranks(spec: dict, args) -> list[dict]:
    """Every rank's readings, rank 0's first."""
    from portbench import harness

    ranks = spec["mix"].get("ranks", 1)
    if ranks == 1:
        return [harness.run_rank(spec, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)]
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    init = {"backend": "nccl", "init_method": f"file://{tmp / 'rendezvous'}", "world_size": ranks}
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    work = (args.workload, args.seed, args.seconds, bool(args.trace), init)
    procs = [ctx.Process(target=_rank_worker, args=(r, work, queue)) for r in range(1, ranks)]
    try:
        for p in procs:
            p.start()
        import torch

        lead = harness.run_rank(spec, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START,
                                mesh_init={**init, "rank": 0, "device_id": torch.device("cuda", 0)})
        others = dict(queue.get(timeout=JOIN_TIMEOUT_S) for _ in procs)
        for p in procs:
            p.join(timeout=JOIN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [lead, *(others[r] for r in range(1, ranks))]


def forbidden_loaded(readings: list[dict]) -> list[str]:
    """The forbidden modules of this process and of every other rank's."""
    from portbench import harness

    return sorted(set(harness.forbidden_modules()).union(*(r.get("forbidden", ()) for r in readings)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import harness

    spec = harness.load_spec(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 3
    readings = run_ranks(spec, args)
    loaded = forbidden_loaded(readings)
    if loaded:
        print(f"portbench: modules of JAX or the JAX package were loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    out, lines = harness.result(spec, readings, bool(args.trace), torch.cuda.get_device_name(0))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
