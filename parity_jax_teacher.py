#!/usr/bin/env python3
"""The JAX package's side of the distillation parity protocol: the teachers
and the JAX students, on the CPU.

    JAX_PLATFORMS=cpu python3 parity_jax_teacher.py [--seeds 1 2 ... 10]

``benchmarks/parity_distillation.py`` trains its teacher into a temporary
directory, so the port's side (``parity_torch.py`` studies ``f`` and
``f_rec``) has no teacher to read. This script trains both teachers with
that script's own ``train_teacher`` (PPO, ``train_cfg(0)``, 64 envs, 400
iterations): on ``Pendulum`` for ``f`` and on the privileged obs of
``PrivilegedPendulum`` for ``f_rec``. It copies each one's reference-layout
checkpoint (``teacher_ref.pt``, from ``export_torch_state_dict``) into
``parity_teachers/`` and prints each teacher's trailing reward beside the
committed files' (``teacher_trailing_reward``, -864.0). Then it distils the
JAX students from those same teachers (``run_ours``, seeds 1-10, 200 and 300
iterations) and writes their reward and loss curves and per-seed finals (the
nan-aware mean of the last 20 iterations) to
``parity_jax_distill_results.json``, the reference ``parity_torch.py``'s
distillation studies are held against. It needs JAX, so it runs where the
JAX package does, not on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
import warnings

import jax
import numpy as np

from benchmarks.parity_distillation import TEACHER_ITERATIONS, run_ours, train_teacher

ROOT = os.path.dirname(os.path.abspath(__file__))
NUM_ENVS, WINDOW = 64, 20
#: study -> (privileged teacher and recurrent student, student iterations,
#: the teacher's file in parity_teachers/, the committed JAX file)
STUDIES = {"f": (False, 200, "teacher_ref.pt", "parity_distillation.json"),
           "f_rec": (True, 300, "teacher_privileged_ref.pt", "parity_distillation_recurrent.json")}


def finals(curves: np.ndarray) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmean(curves[:, -WINDOW:], axis=1)


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=list(range(1, 11)))
    p.add_argument("--studies", nargs="+", default=list(STUDIES), choices=list(STUDIES))
    p.add_argument("--iterations", type=int, default=None, help="the students' iterations (default: the protocol's)")
    p.add_argument("--teachers", default=os.path.join(ROOT, "parity_teachers"))
    p.add_argument("--out", default=os.path.join(ROOT, "parity_jax_distill_results.json"))
    args = p.parse_args()
    os.makedirs(args.teachers, exist_ok=True)
    results = {"platform": jax.devices()[0].platform, "jax": jax.__version__, "num_envs": NUM_ENVS,
               "teachers": {}, "studies": {}}
    for name in args.studies:
        privileged, iterations, teacher_file, committed = STUDIES[name]
        iterations = args.iterations or iterations
        with open(os.path.join(ROOT, "benchmarks", "results", committed)) as f:
            committed_reward = json.load(f)["teacher_trailing_reward"]
        with tempfile.TemporaryDirectory() as tmp:
            start = time.perf_counter()
            ours_ckpt, ref_ckpt, reward = train_teacher(tmp, NUM_ENVS, privileged=privileged)
            teacher_s = time.perf_counter() - start
            shutil.copyfile(ref_ckpt, os.path.join(args.teachers, teacher_file))
            results["teachers"][name] = {"file": f"parity_teachers/{teacher_file}", "privileged": privileged,
                                         "iterations": TEACHER_ITERATIONS, "trailing_reward": reward,
                                         "committed_trailing_reward": committed_reward, "seconds": teacher_s}
            print(json.dumps({"teacher": name, **results["teachers"][name]}), flush=True)
            start = time.perf_counter()
            curves, losses = [], []
            for seed in args.seeds:
                rewards, loss = run_ours(seed, iterations, ours_ckpt, NUM_ENVS, recurrent=privileged)
                curves.append(rewards)
                losses.append(loss)
                print(json.dumps({"study": name, "seed": seed,
                                  "final": float(finals(np.asarray([rewards], np.float64))[0])}), flush=True)
        curves = np.asarray(curves, np.float64)
        per_seed = finals(curves)
        results["studies"][name] = {
            "committed_file": f"benchmarks/results/{committed}", "iterations": iterations, "seeds": args.seeds,
            "wall_s": time.perf_counter() - start, "finals": per_seed.tolist(),
            "mean": float(per_seed.mean()), "std": float(per_seed.std()),
            "curves": [[None if np.isnan(v) else float(v) for v in c] for c in curves],
            "loss_curves": losses}
        print(json.dumps({"study": name, "mean": float(per_seed.mean()), "std": float(per_seed.std())}), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f)


if __name__ == "__main__":
    main()
