#!/usr/bin/env python3
"""The JAX package's side of the feedforward NLink parity protocol, run as a
multi-seed study and as single-seed runs, on the CPU.

    JAX_PLATFORMS=cpu python3 parity_jax_study.py [--study-seeds 40] [--single-seeds 10] [--seed-offset 0]
    JAX_PLATFORMS=cpu python3 parity_jax_study.py --merge FILE [FILE ...] [--out FILE]

The committed JAX bands of the feedforward study (``benchmarks/results/
parity_nlink{,_b,_c}.json``) come from single-seed runners
(``benchmarks/parity_nlink.py::run_ours``), while ``parity_torch.py``'s
``b`` and ``b40`` run the port's seeds as one ``MultiSeedRunner``. This
script runs both forms of the same protocol with the JAX package
(``benchmarks/parity_pendulum.py``'s ``train_cfg``, 64 ``NLinkPendulum``
envs of 5 links, ``max_episode_length=400``, 500 iterations): one
``MultiSeedRunner`` of ``--study-seeds`` seeds (seed 1), and
``--single-seeds`` single-seed runs (seeds 1, 2, ...). It writes the
per-seed finals (the nan-aware mean of the last 20 iterations' mean
reward) and curves to ``parity_jax_results.json``. ``--seed-offset K`` runs
the single seeds ``K + 1 ..`` and ``--study-seeds 0`` skips the study;
``--merge`` pools the single seeds of earlier ``--out`` files by seed (it
trains nothing). Then it holds every port study stored in
``parity_torch_results.json`` against the JAX finals of the port study's
own seeds in the same form (``b40`` against the study; ``b_single``,
``b40_single``, their ``_s<seed>`` sets and what ``parity_torch.py --pool``
made of them against single runs: the committed files' seeds 1-40, this
run's in their place), wherever this run gave some of those seeds, and
prints and stores Welch's t and Mann-Whitney U p-values under
``against_port``. It needs JAX, so it runs where the JAX package does, not
on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import jax
import numpy as np

from benchmarks.parity_nlink import MAX_EPISODE_LENGTH, NUM_LINKS, run_ours
from benchmarks.parity_pendulum import train_cfg
from rsl_rl_tpu.env import NLinkPendulum
from rsl_rl_tpu.runners import MultiSeedRunner
from parity_torch import finals, jax_finals, p_values

ROOT = os.path.dirname(os.path.abspath(__file__))
ITERATIONS, NUM_ENVS = 500, 64
#: the committed JAX single-seed runs of the protocol (seeds 1-10, 11-20, 21-40)
COMMITTED = ("parity_nlink.json", "parity_nlink_b.json", "parity_nlink_c.json")
#: the port's studies of each JAX form: one ``MultiSeedRunner`` of seeds
#: 1..N, or a runner a seed
FORMS = {"b40": "study", "b_single": "single", "b40_single": "single"}


def run_study(num_seeds: int) -> np.ndarray:
    """Curves ``[seeds, iterations]`` of one JAX ``MultiSeedRunner``."""
    env = NLinkPendulum(num_envs=NUM_ENVS, num_links=NUM_LINKS, max_episode_length=MAX_EPISODE_LENGTH)
    runner = MultiSeedRunner(env, train_cfg(1), num_seeds=num_seeds)
    ts, cs = runner.train_state, runner.collect_state
    points = []
    for _ in range(ITERATIONS):
        ts, cs, m = runner._train_step(ts, cs)
        m = jax.device_get(m)
        count = np.asarray(m["ep_count"], np.float64)
        total = np.asarray(m["ep_reward_sum"], np.float64)
        points.append(np.where(count > 0, total / np.maximum(count, 1.0), np.nan))
    return np.stack(points, axis=1)


def single_finals(results: dict) -> dict[int, float]:
    """JAX single-seed finals by seed: the committed files' (``COMMITTED``),
    then this run's, which take a seed's place."""
    table = {}
    for name in COMMITTED:
        with open(os.path.join(ROOT, "benchmarks", "results", name)) as f:
            seeds = json.load(f)["seeds"]
        table.update(zip(seeds, jax_finals(name)[0].tolist()))
    single = results.get("single", {})
    table.update(zip(single.get("seeds", []), single.get("finals", [])))
    return table


def form_of(name: str, port: dict) -> str | None:
    """The JAX form a stored port study has (``study`` or ``single``): that
    of the study it was pooled from, or of its name less a ``_s<seed>``."""
    if "pooled_from" in port[name]:
        return form_of(port[name]["pooled_from"][0], port)
    return FORMS.get(re.sub(r"_s\d+$", "", name))


def against_port(results: dict) -> None:
    """Every stored port study (``parity_torch_results.json``) held against
    the JAX finals of its own seeds, of the same form, where this run gave
    some of them; printed and stored under ``against_port``."""
    port_path = os.path.join(ROOT, "parity_torch_results.json")
    port = json.load(open(port_path))["studies"] if os.path.exists(port_path) else {}
    run_seeds = {"study": set(range(1, results["study"]["seeds"] + 1)) if "study" in results else set(),
                 "single": set(results.get("single", {}).get("seeds", []))}
    tables = {"study": dict(zip(sorted(run_seeds["study"]), results.get("study", {}).get("finals", []))),
              "single": single_finals(results)}
    results["against_port"] = {}
    for name, study in port.items():
        form = form_of(name, port)
        seeds = study.get("seed_list", list(range(1, study["seeds"] + 1)))
        if form is None or not set(seeds) & run_seeds[form] or not set(seeds) <= set(tables[form]):
            continue
        jax_ = np.asarray([tables[form][s] for s in seeds])
        port_finals = np.asarray(study["port"]["per_seed"])
        line = {"form": form, "port_study": name, "seeds": f"{min(seeds)}-{max(seeds)}",
                "jax_mean": float(jax_.mean()), "jax_std": float(jax_.std()), "port_mean": float(port_finals.mean()),
                "port_std": float(port_finals.std()), "n": len(seeds), **p_values(port_finals, jax_)}
        results["against_port"][name] = line
        print(json.dumps(line), flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--study-seeds", type=int, default=40, help="0 skips the multi-seed study")
    p.add_argument("--single-seeds", type=int, default=10)
    p.add_argument("--seed-offset", type=int, default=0, help="run the single seeds OFFSET+1..")
    p.add_argument("--merge", nargs="+", metavar="FILE", help="pool these files' single seeds (trains nothing)")
    p.add_argument("--out", default=os.path.join(ROOT, "parity_jax_results.json"))
    args = p.parse_args()

    results = {"platform": jax.devices()[0].platform, "jax": jax.__version__, "iterations": ITERATIONS}
    if args.merge:
        parts = [json.load(open(path))["single"] for path in args.merge]
        by_seed = {s: (f, c) for part in parts for s, f, c in zip(part["seeds"], part["finals"], part["curves"])}
        seeds = sorted(by_seed)
        results["single"] = {"seeds": seeds, "finals": [by_seed[s][0] for s in seeds],
                             "curves": [by_seed[s][1] for s in seeds],
                             "wall_s": sum(part["wall_s"] for part in parts),
                             "merged_from": [name for path, part in zip(args.merge, parts)
                                             for name in part.get("merged_from", [os.path.basename(path)])]}
    else:
        if args.study_seeds:
            start = time.perf_counter()
            study = run_study(args.study_seeds)
            results["study"] = {"seeds": args.study_seeds, "wall_s": time.perf_counter() - start,
                                "finals": finals(study).tolist(),
                                "curves": [[None if np.isnan(v) else float(v) for v in c] for c in study]}
        start = time.perf_counter()
        seeds = list(range(args.seed_offset + 1, args.seed_offset + args.single_seeds + 1))
        single = np.asarray([run_ours(s, ITERATIONS) for s in seeds], np.float64)
        results["single"] = {"seeds": seeds, "wall_s": time.perf_counter() - start,
                             "finals": finals(single).tolist(),
                             "curves": [[None if np.isnan(v) else float(v) for v in c] for c in single]}
    against_port(results)
    with open(args.out, "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
