#!/usr/bin/env python3
"""How far two ranks drift from one process, over seeds, and why.

    python3 parallel_drift.py [--seeds 1 2 3] [--iterations 2] [--kinds device host tp_headline]
                              [--optimizer adam|sgd]

For each kind and seed it trains one configuration three times: in one
process, in one process from initial weights perturbed by one part in 1e7,
and on two Gloo ranks sharing the card (this script spawns them). The kinds:

- ``device``: the GRU-256 flagship (``chip_smoke.RECURRENT_GRU256``) on
  4096 ``NLinkPendulum`` envs on the card, two data ranks;
- ``host``: the same on ``chip_smoke.HostNLink`` stepped on the CPU, each
  data rank stepping its 2048-env shard;
- ``tp_headline``: the bf16 headline (``chip_smoke.PPO_FF256X3_BF16``) on
  the device env, two model ranks (``model_parallel_size: 2``).

Every minibatch's KL and learning rate (before and after the adaptive-KL
rule) are recorded on each side. One JSON line a kind and seed gives the
parameters' largest difference from the one-process run and its norm over
the norm of the one-process update, the policy outputs' largest difference,
for the ranks and for the perturbed run, and the first minibatch whose
learning rate differs from the one-process run's, with both KLs there and
the one-process KL's relative distance to the rule's nearest threshold
(``2 * desired_kl`` or ``desired_kl / 2``). The full traces go to
``--out``. ``--optimizer sgd`` trains every run with SGD instead of the
configurations' Adam. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
from rsl_rl_tpu_torch.parallel import distributed_init

WORLD = 2
KINDS = ("device", "host", "tp_headline")


def run(kind: str, seed: int, iterations: int, optimizer: str, rank: int = 0, distributed: bool = False,
        perturb: bool = False):
    """One run: ``{"state0", "state", "outputs", "trace"}``. A host env is this
    rank's shard of the global env when ``distributed``."""
    cfg = copy.deepcopy(cs.PPO_FF256X3_BF16 if kind == "tp_headline" else cs.RECURRENT_GRU256)
    cfg["seed"] = seed
    cfg["algorithm"]["optimizer"] = optimizer
    if kind == "tp_headline" and distributed:
        cfg["model_parallel_size"] = WORLD
    if kind == "host":
        n = cs.NUM_ENVS // WORLD if distributed else cs.NUM_ENVS
        env = cs.HostNLink(n, env_offset=rank * n, seed=seed)
    else:
        env = cs.NLinkPendulum(cs.NUM_ENVS, cs.NUM_LINKS, device="cuda")
    runner = cs.OnPolicyRunner(env, cfg, device="cuda")
    if perturb:
        gen = torch.Generator(device="cuda").manual_seed(7)
        with torch.no_grad():
            for p in runner.alg.policy.parameters():
                p.mul_(1.0 + 1e-7 * torch.randn(p.shape, generator=gen, device="cuda"))
    state0 = cs.full_state(runner.alg)
    trace = cs.trace_lr(runner.alg)
    runner.learn(iterations)
    return {"state0": state0, "state": cs.full_state(runner.alg), "outputs": cs.parallel_result(runner)["outputs"],
            "trace": trace}


def compare(got: dict, want: dict) -> dict:
    """``got`` against the one-process run ``want`` (rank 0's outputs are
    those of its envs, the first rows of the global batch)."""
    names = [n for n in want["state"] if not n.startswith("norm_")]
    diff = sum(float(((got["state"][n].float() - want["state"][n].float()) ** 2).sum()) for n in names) ** 0.5
    update = sum(float(((want["state"][n].float() - want["state0"][n].float()) ** 2).sum()) for n in names) ** 0.5
    return {"max_abs_diff": max(float((got["state"][n].float() - want["state"][n].float()).abs().max())
                                for n in names),
            "diff_over_update": diff / update,
            "outputs_max_abs_diff": float((got["outputs"] - want["outputs"][:len(got["outputs"])]).abs().max()),
            "lr_flip": cs.first_flip(got["trace"], want["trace"])}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    parser.add_argument("--optimizer", default="adam", choices=("adam", "sgd"))
    parser.add_argument("--out", default=os.path.join("chiprun_out", "parallel_drift.json"),
                        help="where the full traces go")
    parser.add_argument("--rank", type=int, default=None, help="(internal) run as this rank")
    parser.add_argument("--dir", default=None, help="(internal) the run's directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    keys = [(k, s) for k in args.kinds for s in args.seeds]
    if args.rank is not None:
        distributed_init(backend="gloo", init_method=f"file://{args.dir}/rendezvous", rank=args.rank,
                         world_size=WORLD)
        out = {f"{k}:{s}": run(k, s, args.iterations, args.optimizer, args.rank, distributed=True) for k, s in keys}
        if args.rank == 0:
            torch.save(out, os.path.join(args.dir, "ranks.pt"))
        torch.distributed.destroy_process_group()
        return
    cs.cuda_build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    refs = {f"{k}:{s}": run(k, s, args.iterations, args.optimizer) for k, s in keys}
    moved = {f"{k}:{s}": run(k, s, args.iterations, args.optimizer, perturb=True) for k, s in keys}
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, os.path.abspath(__file__), "--dir", tmp, "--iterations", str(args.iterations),
               "--seeds", *map(str, args.seeds), "--kinds", *args.kinds, "--optimizer", args.optimizer]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(WORLD)]
        if any(p.wait(timeout=1800) != 0 for p in procs):
            cs.fail("a rank failed")
        ranks = torch.load(os.path.join(tmp, "ranks.pt"), weights_only=False)
    traces = {}
    for key, want in refs.items():
        kind, seed = key.split(":")
        print(json.dumps({"kind": kind, "seed": int(seed), "iterations": args.iterations, "optimizer": args.optimizer,
                          "ranks": compare(ranks[key], want), "perturbed_1e-7": compare(moved[key], want),
                          "card": smi}))
        traces[key] = {"one_process": want["trace"], "ranks": ranks[key]["trace"], "perturbed": moved[key]["trace"]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "columns": ["kl", "lr_before", "lr_after"], "traces": traces}, f)


if __name__ == "__main__":
    main()
