"""The readings a cell's limits are set from (not run by the benchmark's runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--runs program control ...]

On the card, at the cell's own size. For each seed, one JSON line of the
check's numbers (``portbench/check.py``) of each run against the plain
reference in the configuration's precision, from the same weights and draws:

- ``program``: the port's checked steps through ``learn`` on the cell's path
  (sound runs; their largest reading is a limit's lower end), with the
  seconds each side took. A cell of several ranks reads its sound runs from
  the benchmark's own runs;
- ``control``: the reference in the nearest precision below the
  configuration's (TF32 for fp32 with TF32 off, float8 e4m3 trunk operands
  for bf16 trunks);
- ``half_batch``: the reference with each minibatch's loss taken over its
  first half alone (the planted fault);
- ``mesh_sums`` (a cell of several ranks): the reference with each
  minibatch's gradients summed over the ranks' shares in rank order, the
  witness of what the mesh's reordered sums alone read.

A state left unchanged reads ``change_gap`` 1 and needs no run.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the control's precision for each configured one
CONTROL = {"fp32": "tf32", "bf16": "fp8"}
RUNS = ("program", "control", "half_batch", "mesh_sums")
DEVICE = "cuda"


def default_runs(spec: dict) -> tuple[str, ...]:
    """Every run that applies to the cell: the program in one process, or the mesh's witness."""
    one = spec["mix"].get("ranks", 1) == 1
    return tuple(r for r in RUNS if r != ("mesh_sums" if one else "program"))


def readings(spec: dict, seed: int, runs) -> dict:
    """The numbers of ``runs`` for one seed, at the mix's size."""
    from portbench import harness

    mix, config = spec["mix"], spec["config"]
    ranks = mix.get("ranks", 1)
    n = mix["envs_per_rank"] * ranks
    harness.set_precision()
    weights, _, _ = harness.make_cell_weights(spec, seed, DEVICE)
    out = {"seed": seed}
    if "program" in runs:
        out.update(_program(spec, seed, n, weights))
    free = {"control": {"control": CONTROL[config["precision"]]}, "half_batch": {"half_batch": True},
            "mesh_sums": {"parts": ranks}}
    for run in (r for r in RUNS if r in runs and r in free):
        steps = harness.free_run(spec, seed, DEVICE, n, weights, **free[run])
        out[run] = harness.check_numbers(spec, seed, DEVICE, n, weights, steps)
    return out


def _program(spec: dict, seed: int, n: int, weights: dict) -> dict:
    """The program's numbers on one process, with the seconds each side took."""
    import torch

    from portbench import harness

    t = time.perf_counter()
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        program = harness.Program(spec, seed, DEVICE, n, weights)
        steps = program.check_steps(spec["mix"].get("init_at_random_ep_len", False))
    del program
    gc.collect()
    torch.cuda.empty_cache()
    seconds = {"program": time.perf_counter() - t}
    t = time.perf_counter()
    out = {"program": harness.check_numbers(spec, seed, DEVICE, n, weights, steps)}
    seconds["reference"] = time.perf_counter() - t
    return {**out, "seconds": seconds}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--runs", nargs="+", choices=RUNS, help="default: every run that applies to the cell")
    args = parser.parse_args(argv)

    from portbench import harness

    spec = harness.load_spec(args.workload)
    runs = args.runs or default_runs(spec)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, **readings(spec, seed, runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
