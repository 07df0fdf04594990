#!/usr/bin/env python3
"""The JAX package's side of the feedforward NLink parity protocol, run as a
multi-seed study and as single-seed runs, on the CPU.

    JAX_PLATFORMS=cpu python3 parity_jax_study.py [--study-seeds 40] [--single-seeds 10]

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
reward) and curves to ``parity_jax_results.json``, and, where
``parity_torch_results.json`` holds the port's ``b40`` and ``b_single``
studies, prints Welch's t and Mann-Whitney U p-values of each port study
against the JAX run of the same form. It needs JAX, so it runs where the
JAX package does, not on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import jax
import numpy as np

from benchmarks.parity_nlink import MAX_EPISODE_LENGTH, NUM_LINKS, run_ours
from benchmarks.parity_pendulum import train_cfg
from rsl_rl_tpu.env import NLinkPendulum
from rsl_rl_tpu.runners import MultiSeedRunner

ROOT = os.path.dirname(os.path.abspath(__file__))
ITERATIONS, NUM_ENVS, WINDOW = 500, 64, 20


def finals(curves: np.ndarray) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmean(curves[:, -WINDOW:], axis=1)


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


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--study-seeds", type=int, default=40)
    p.add_argument("--single-seeds", type=int, default=10)
    p.add_argument("--out", default=os.path.join(ROOT, "parity_jax_results.json"))
    args = p.parse_args()
    from scipy import stats

    results = {"platform": jax.devices()[0].platform, "jax": jax.__version__, "iterations": ITERATIONS}
    start = time.perf_counter()
    study = run_study(args.study_seeds)
    results["study"] = {"seeds": args.study_seeds, "wall_s": time.perf_counter() - start,
                        "finals": finals(study).tolist(),
                        "curves": [[None if np.isnan(v) else float(v) for v in c] for c in study]}
    start = time.perf_counter()
    single = np.asarray([run_ours(s, ITERATIONS) for s in range(1, args.single_seeds + 1)], np.float64)
    results["single"] = {"seeds": list(range(1, args.single_seeds + 1)), "wall_s": time.perf_counter() - start,
                         "finals": finals(single).tolist(),
                         "curves": [[None if np.isnan(v) else float(v) for v in c] for c in single]}
    port_path = os.path.join(ROOT, "parity_torch_results.json")
    port = json.load(open(port_path))["studies"] if os.path.exists(port_path) else {}
    for form, port_study in (("study", "b40"), ("single", "b_single")):
        jax_finals = np.asarray(results[form]["finals"])
        line = {"form": form, "jax_mean": float(jax_finals.mean()), "jax_std": float(jax_finals.std()),
                "jax_seeds": len(jax_finals)}
        if port_study in port:
            port_finals = np.asarray(port[port_study]["port"]["per_seed"])
            line.update(port_study=port_study, port_mean=float(port_finals.mean()),
                        port_std=float(port_finals.std()), port_seeds=len(port_finals),
                        welch_t_p=float(stats.ttest_ind(port_finals, jax_finals, equal_var=False).pvalue),
                        mann_whitney_u_p=float(stats.mannwhitneyu(port_finals, jax_finals,
                                                                  alternative="two-sided").pvalue))
        results[f"{form}_against_port"] = line
        print(json.dumps(line), flush=True)
    with open(args.out, "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
