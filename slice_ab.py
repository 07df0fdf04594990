#!/usr/bin/env python3
"""Time the four slices' training iterations from two source trees on one card, in turns.

    python3 slice_ab.py BASE_ROOT [--iterations 8] [--trace]

``BASE_ROOT`` is the root of another checkout of the repository (for example
the parent commit unpacked with ``git archive`` into ``build/base``). Each
turn is a process of its own that imports the port from one tree (its kernels
built into that tree's ``build/``) and trains the slices of ``chip_smoke.py``
phase 4 (``recurrent_gru256``, ``recurrent_lstm256_bf16``,
``multiseed8_recurrent_gru256``, ``multiseed8_recurrent_lstm256_bf16``) for
``--iterations`` iterations each, in the order base, this, this, base, so that
a drift of the card or its host during the run shows. One line a slice and
turn with the mean collection and learning seconds and env-steps/s of the
iterations after the first (which holds the warm-up), then each slice's two
turns of a tree averaged and the ratio this/base. The card's name and power
limit first.

With ``--trace`` each turn then profiles one more iteration of each slice
with ``torch.profiler`` (CPU and CUDA activity), each phase inside a
``record_function`` range that ends with a ``torch.cuda.synchronize()``. For
the collection and the learning phase it prints the wall-clock seconds, the
device busy share (the union of the device's kernel and copy intervals over
the phase's wall-clock time) and the device seconds it makes (busy share x
wall clock), the share taken by the port's own kernels (the
``__global__`` functions of that tree's ``rsl_rl_tpu_torch/csrc``: a slice
launches only its own three RNN entry points), and the learning phase's
largest device kernels.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KEYS = ("collection_s", "learn_s", "steps_per_s")
PHASES = ("collection", "learning")
#: the runners' collect and update calls, single-seed and stacked
PHASE_CALLS = {False: ("collect", "update"), True: ("collect_stacked", "update_stacked")}


def steady(history: list[dict]) -> dict:
    """The mean of each of :data:`KEYS` over the iterations after the first."""
    rows = history[1:] or history
    return {k: sum(row[k] for row in rows) / len(rows) for k in KEYS}


def port_kernels(root: Path) -> set[str]:
    """The names of the ``__global__`` functions in the tree's ``csrc``."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")
    return {m for path in (root / "rsl_rl_tpu_torch" / "csrc").glob("*.cu*") for m in pattern.findall(path.read_text())}


def union_s(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] (microseconds) that the intervals cover."""
    covered, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            covered += b - a
            end = b
    return covered * 1e-6


def trace_iteration(runner, stacked: bool, kernels: set[str]) -> dict:
    """Profile one iteration of ``runner.learn``: per phase its wall-clock
    seconds, device busy share, the port's kernels' share, and (learning) the
    five kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(label, fn):
        def call(*args, **kwargs):
            with record_function(label):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            return out
        return call

    alg = runner.alg
    for label, attr in zip(PHASES, PHASE_CALLS[stacked]):
        setattr(alg, attr, ranged(label, getattr(alg, attr)))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runner.learn(1)
    finally:
        for attr in PHASE_CALLS[stacked]:
            delattr(alg, attr)
    events = prof.events()
    windows = {e.name: (e.time_range.start, e.time_range.end) for e in events
               if e.name in PHASES and e.device_type == DeviceType.CPU}
    device = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CUDA and e.name not in PHASES]
    out = {"device_events": len(device)}
    for label, (lo, hi) in windows.items():
        inside = [(a, b, n) for a, b, n in device if b > lo and a < hi]
        wall = (hi - lo) * 1e-6
        own = [(a, b) for a, b, n in inside if any(k in n for k in kernels)]
        out[label] = {"wall_s": wall, "busy": union_s([(a, b) for a, b, _ in inside], lo, hi) / wall,
                      "port_kernels": union_s(own, lo, hi) / wall}
        if label == "learning":
            by_name: dict[str, float] = {}
            for a, b, n in inside:
                by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-3
            out[label]["top_ms"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return out


def run_turn(root: Path, iterations: int, trace: bool) -> None:
    """Train the slices with the port of the tree at ``root``; print one JSON
    line ``{slice: steady(history)}`` last (with ``trace``, each slice's
    :func:`trace_iteration` under ``"trace"``)."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.cuda_build.build_all()
    kernels = port_kernels(root)
    out = {}
    runners = {name: (False, lambda cfg=cfg: cs.OnPolicyRunner(
        cs.NLinkPendulum(cs.NUM_ENVS, cs.NUM_LINKS, device="cuda"), cfg, device="cuda"))
        for name, (_, cfg) in cs.SLICES.items()}
    runners.update({name: (True, lambda cfg=cfg: cs.MultiSeedRunner(
        cs.NLinkPendulum(cs.ENVS_PER_SEED, cs.NUM_LINKS, device="cuda"), cfg, cs.NUM_SEEDS, device="cuda"))
        for name, (_, cfg) in cs.MULTISEED_SLICES.items()})
    for name, (stacked, make) in runners.items():
        runner = make()
        runner.learn(iterations)
        out[name] = steady(runner.history)
        if trace:
            out[name]["trace"] = trace_iteration(runner, stacked, kernels)
    print(json.dumps(out))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("base_root", type=Path)
    parser.add_argument("--iterations", type=int, default=8)
    parser.add_argument("--trace", action="store_true", help="also profile one iteration of each slice a turn")
    parser.add_argument("--turn", action="store_true", help="run one turn in this process (internal)")
    args = parser.parse_args()
    if args.turn:
        run_turn(args.base_root.resolve(), args.iterations, args.trace)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    results: dict[str, dict[str, list[dict]]] = {}
    for label, root in (("base", args.base_root), ("this", ROOT), ("this", ROOT), ("base", args.base_root)):
        cmd = [sys.executable, __file__, str(root), "--iterations", str(args.iterations), "--turn"]
        proc = subprocess.run(cmd + (["--trace"] if args.trace else []), capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{label} turn failed ({proc.returncode}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        for name, row in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            results.setdefault(name, {}).setdefault(label, []).append(row)
            print(f"turn {label} {name}: collection {row['collection_s']:.4f} s, learning {row['learn_s']:.4f} s,"
                  f" {row['steps_per_s']:.0f} env-steps/s")
            if "trace" in row:
                tr = row["trace"]
                print(f"trace {label} {name}: {tr['device_events']} device events; " + "; ".join(
                    f"{p} {tr[p]['wall_s']:.4f} s, device busy {tr[p]['busy']:.1%}"
                    f" ({tr[p]['busy'] * tr[p]['wall_s']:.4f} s), port kernels {tr[p]['port_kernels']:.1%}"
                    for p in PHASES if p in tr))
                top = tr.get("learning", {}).get("top_ms", [])
                print(f"trace {label} {name} learning, most device ms: "
                      + "; ".join(f"{n[:70]} {ms:.2f}" for n, ms in top))
    for name, turns in results.items():
        mean = {label: {k: sum(r[k] for r in rows) / len(rows) for k in KEYS} for label, rows in turns.items()}
        b, t = mean["base"], mean["this"]
        print(f"ab {name}: collection base {b['collection_s']:.4f} this {t['collection_s']:.4f} s;"
              f" learning base {b['learn_s']:.4f} this {t['learn_s']:.4f} s (this/base"
              f" {t['learn_s'] / b['learn_s']:.4f}); env-steps/s base {b['steps_per_s']:.0f}"
              f" this {t['steps_per_s']:.0f} (this/base {t['steps_per_s'] / b['steps_per_s']:.4f})")


if __name__ == "__main__":
    main()
