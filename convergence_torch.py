#!/usr/bin/env python3
"""Full-width convergence of the port's flagships against the JAX package's
convergence studies.

    python3 convergence_torch.py [--studies gru_fp32 lstm_bf16 ff_bf16] [--iterations N] [--device cuda]

The port's side of ``benchmarks/convergence_tpu.py``: each seed trains one
``OnPolicyRunner`` built as ``bench.py::_build`` builds that policy, on 4096
envs of 5 links, T=24, 5 epochs x 4 minibatches, ``noise_std_floor=0.01``
(the ``--std-floor 0.01`` of the JAX files), every iteration one CUDA graph
replay (``fuse_iteration=True``). A curve holds each iteration's mean reward
over the episodes completed in it (nan when none completed); a seed's final
is the mean of the non-nan points among its last 100 iterations
(``convergence_tpu.py``'s ``final_mean_reward_100``). One difference of
form: each JAX seed starts from ``_build``'s fixed initial parameters
(``PRNGKey(1)``) and collect state (``PRNGKey(2)``) and varies only the
training key (``fold_in(ts.rng, seed)``); here the seed also draws the
initial policy and the envs' initial state, as ``OnPolicyRunner`` seeds
them, so the port's band holds the initialisation's variance too. The
studies:

- ``gru_fp32``: ``ActorCriticRecurrent`` with GRU-256 memories and [256,
  256] heads, fp32, on ``PartiallyObservableNLink``, 1000 iterations, 8 seeds;
  against ``convergence_tpu_floor_gru_fp32.json`` (3 JAX seeds, so the tests
  have little power).
- ``lstm_bf16``: the same with LSTM-256 memories and bf16 trunks; against
  ``convergence_tpu_floor_lstm_bf16.json`` (8 JAX seeds).
- ``ff_bf16``: the headline ``ActorCritic`` [256, 256, 256], bf16 trunks with
  fp32 heads, on ``NLinkPendulum``, 2000 iterations, 8 seeds; against
  ``convergence_tpu_floor.json`` (8 JAX seeds).

Per study the script prints the port's per-seed finals, their mean and std,
and Welch's t and Mann-Whitney U p-values against the JAX file's
``per_seed`` finals, and writes ``convergence_torch_results.json`` (curves,
wall seconds a seed, the card's name and power limit) at the root of the
repository, keeping the studies already stored there. ``--iterations``
shortens and ``--num-envs`` narrows every study (a rehearsal; the protocol's
counts are the default); ``--device cpu`` runs a rehearsal on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time

import numpy as np
import torch

from parity_torch import band, card, curve_point, p_values, quiet_learn
from rsl_rl_tpu_torch.env import NLinkPendulum, PartiallyObservableNLink
from rsl_rl_tpu_torch.runners import OnPolicyRunner

ROOT = os.path.dirname(os.path.abspath(__file__))
RESULTS = os.path.join(ROOT, "benchmarks", "results")
OUT = os.path.join(ROOT, "convergence_torch_results.json")
NUM_ENVS, NUM_LINKS, NUM_STEPS, SEEDS = 4096, 5, 24, 8
STD_FLOOR = 0.01
FINAL_WINDOW = 100
ENVS = {"po_nlink": PartiallyObservableNLink, "nlink": NLinkPendulum}

#: name -> (JAX file, env, policy ("ff" or the memory), bf16, iterations)
STUDIES = {
    "gru_fp32": ("convergence_tpu_floor_gru_fp32.json", "po_nlink", "gru", False, 1000),
    "lstm_bf16": ("convergence_tpu_floor_lstm_bf16.json", "po_nlink", "lstm", True, 1000),
    "ff_bf16": ("convergence_tpu_floor.json", "nlink", "ff", True, 2000),
}


def train_cfg(name: str, seed: int) -> dict:
    """``bench.py::_build``'s policy and algorithm for study ``name``: GRU or
    LSTM-256 memories with [256, 256] heads, or the headline [256, 256, 256]
    trunks; obs normalization; bf16 trunks (fp32 heads) where the study is
    bf16; ``PPO(num_learning_epochs=5, num_mini_batches=4)``, the rest at
    PPO's defaults."""
    _, _, memory, bf16, _ = STUDIES[name]
    if memory == "ff":
        policy = {"class_name": "ActorCritic", "actor_hidden_dims": [256, 256, 256],
                  "critic_hidden_dims": [256, 256, 256]}
    else:
        policy = {"class_name": "ActorCriticRecurrent", "rnn_type": memory, "rnn_hidden_dim": 256,
                  "actor_hidden_dims": [256, 256], "critic_hidden_dims": [256, 256]}
    policy.update(actor_obs_normalization=True, critic_obs_normalization=True, noise_std_floor=STD_FLOOR)
    if bf16:
        policy["dtype"] = torch.bfloat16
    return {"num_steps_per_env": NUM_STEPS, "save_interval": 10_000, "seed": seed,
            "obs_groups": {"policy": ["policy"], "critic": ["policy"]}, "policy": policy,
            "algorithm": {"class_name": "PPO", "num_learning_epochs": 5, "num_mini_batches": 4},
            "fuse_iteration": True}


def make_runner(name: str, seed: int, device: str, num_envs: int = NUM_ENVS) -> OnPolicyRunner:
    env = ENVS[STUDIES[name][1]](num_envs, num_links=NUM_LINKS, device=device)
    return OnPolicyRunner(env, train_cfg(name, seed), device=device)


def final(curve: np.ndarray) -> float:
    """The mean of the non-nan points among the last ``FINAL_WINDOW``."""
    tail = curve[-FINAL_WINDOW:]
    tail = tail[~np.isnan(tail)]
    return float(tail.mean()) if len(tail) else float("nan")


def run_seed(name: str, seed: int, iterations: int, device: str, num_envs: int = NUM_ENVS) -> dict:
    """One seed's curve, final and wall seconds (the runner's construction
    and every iteration, its graph capture included)."""
    start = time.perf_counter()
    runner = make_runner(name, seed, device, num_envs)
    quiet_learn(runner, iterations)
    curve = np.asarray([curve_point(h["metrics"], "ep_reward_sum") for h in runner.history], np.float64)
    wall = time.perf_counter() - start
    del runner
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "final": final(curve), "wall_s": wall,
            "curve": [None if math.isnan(v) else float(v) for v in curve]}


def jax_finals(name: str) -> np.ndarray:
    with open(os.path.join(RESULTS, STUDIES[name][0])) as f:
        return np.asarray(json.load(f)["final_mean_reward_100"]["per_seed"], np.float64)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--studies", nargs="+", default=list(STUDIES), choices=list(STUDIES))
    p.add_argument("--iterations", type=int, default=None, help="shorten every study (a rehearsal)")
    p.add_argument("--num-envs", type=int, default=NUM_ENVS, help="narrow every study (a rehearsal)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=OUT)
    args = p.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("convergence_torch: torch.cuda.is_available() is false")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    smi = card()
    print(smi, flush=True)
    results = {"studies": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    results.update({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    for name in args.studies:
        jax_file, env, memory, bf16, iterations = STUDIES[name]
        iterations = args.iterations or iterations
        runs = []
        for seed in range(1, SEEDS + 1):
            runs.append(run_seed(name, seed, iterations, args.device, args.num_envs))
            print(f"study {name} seed {seed}: final {runs[-1]['final']:.1f} in {runs[-1]['wall_s']:.1f} s",
                  flush=True)
        port = np.asarray([r["final"] for r in runs])
        jax_ = jax_finals(name)
        study = {"jax_file": f"benchmarks/results/{jax_file}", "env": env, "policy": memory,
                 "bf16": bf16, "num_envs": args.num_envs, "iterations": iterations, "noise_std_floor": STD_FLOOR,
                 "final_window": FINAL_WINDOW, "card": smi, "wall_s": sum(r["wall_s"] for r in runs),
                 "port": band(port), "jax": band(jax_), **p_values(port, jax_), "runs": runs}
        results["studies"][name] = study
        print(f"study {name}: " + json.dumps(
            {"port_mean": study["port"]["mean"], "port_std": study["port"]["std"], "jax_mean": study["jax"]["mean"],
             "jax_std": study["jax"]["std"], "jax_seeds": len(jax_), "welch_t_p": study["welch_t_p"],
             "mann_whitney_u_p": study["mann_whitney_u_p"], "wall_s": study["wall_s"]}), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f)
    print(json.dumps({"convergence": {k: {"welch_t_p": v["welch_t_p"], "mann_whitney_u_p": v["mann_whitney_u_p"],
                                          "port_mean": v["port"]["mean"], "jax_mean": v["jax"]["mean"]}
                                      for k, v in results["studies"].items()}, "card": smi}))


if __name__ == "__main__":
    main()
