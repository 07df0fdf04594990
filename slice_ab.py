#!/usr/bin/env python3
"""Time the four slices' training iterations from two source trees on one card, in turns.

    python3 slice_ab.py BASE_ROOT [--iterations 8]

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
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KEYS = ("collection_s", "learn_s", "steps_per_s")


def steady(history: list[dict]) -> dict:
    """The mean of each of :data:`KEYS` over the iterations after the first."""
    rows = history[1:] or history
    return {k: sum(row[k] for row in rows) / len(rows) for k in KEYS}


def run_turn(root: Path, iterations: int) -> None:
    """Train the slices with the port of the tree at ``root``; print one JSON
    line ``{slice: steady(history)}`` last."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.cuda_build.build_all()
    out = {}
    for name, (_, cfg) in cs.SLICES.items():
        runner = cs.OnPolicyRunner(cs.NLinkPendulum(cs.NUM_ENVS, cs.NUM_LINKS, device="cuda"), cfg, device="cuda")
        runner.learn(iterations)
        out[name] = steady(runner.history)
    for name, (_, cfg) in cs.MULTISEED_SLICES.items():
        env = cs.NLinkPendulum(cs.ENVS_PER_SEED, cs.NUM_LINKS, device="cuda")
        runner = cs.MultiSeedRunner(env, cfg, cs.NUM_SEEDS, device="cuda")
        runner.learn(iterations)
        out[name] = steady(runner.history)
    print(json.dumps(out))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("base_root", type=Path)
    parser.add_argument("--iterations", type=int, default=8)
    parser.add_argument("--turn", action="store_true", help="run one turn in this process (internal)")
    args = parser.parse_args()
    if args.turn:
        run_turn(args.base_root.resolve(), args.iterations)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    results: dict[str, dict[str, list[dict]]] = {}
    for label, root in (("base", args.base_root), ("this", ROOT), ("this", ROOT), ("base", args.base_root)):
        proc = subprocess.run([sys.executable, __file__, str(root), "--iterations", str(args.iterations), "--turn"],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{label} turn failed ({proc.returncode}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        for name, row in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            results.setdefault(name, {}).setdefault(label, []).append(row)
            print(f"turn {label} {name}: collection {row['collection_s']:.4f} s, learning {row['learn_s']:.4f} s,"
                  f" {row['steps_per_s']:.0f} env-steps/s")
    for name, turns in results.items():
        mean = {label: {k: sum(r[k] for r in rows) / len(rows) for k in KEYS} for label, rows in turns.items()}
        b, t = mean["base"], mean["this"]
        print(f"ab {name}: collection base {b['collection_s']:.4f} this {t['collection_s']:.4f} s;"
              f" learning base {b['learn_s']:.4f} this {t['learn_s']:.4f} s (this/base"
              f" {t['learn_s'] / b['learn_s']:.4f}); env-steps/s base {b['steps_per_s']:.0f}"
              f" this {t['steps_per_s']:.0f} (this/base {t['steps_per_s'] / b['steps_per_s']:.4f})")


if __name__ == "__main__":
    main()
