#!/usr/bin/env python3
"""Seed-band learning-curve parity of the PyTorch/CUDA port against the JAX
package's committed parity studies.

    python3 parity_torch.py [--studies a b c d] [--iterations N] [--device cuda]

Runs the port's side of the JAX package's parity protocols on the card, each
iteration one CUDA graph replay (``fuse_iteration=True``), and holds each
study's per-seed final rewards against the JAX package's per-seed finals,
read from ``benchmarks/results/*.json``. The protocols are the JAX scripts'
own: ``benchmarks/parity_nlink.py`` (5 links, ``max_episode_length=400``,
64 envs, 500 iterations) and ``benchmarks/parity_pendulum.py``'s
``train_cfg``; the statistic is theirs (``benchmarks/parity_pendulum.py``
``summarize``, ``benchmarks/pool_recurrent_parity.py``): a curve holds each
iteration's mean reward over the episodes completed in it (nan when none
completed), a seed's final is the nan-aware mean over the last 20
iterations, and a study reports the mean and population std of the finals
across seeds, the median and the laggards below -250.

The studies:

- ``a``: recurrent NLink, 40 seeds as one ``MultiSeedRunner`` of 64
  ``PartiallyObservableNLink`` envs each, GRU-64 memories, [128] heads,
  fp32, each env's episode clock scattered once at the start (the JAX
  study's ``--random-ep-len``); against
  ``parity_nlink_recurrent_pooled.json`` (40 JAX seeds).
- ``a_sync``: the same with every env on one episode clock; against
  ``parity_nlink_recurrent_sync20.json`` (20 JAX seeds).
- ``b``: feedforward NLink, 10 seeds as one ``MultiSeedRunner`` of 64
  ``NLinkPendulum`` envs each, [128, 128]; against ``parity_nlink.json``.
- ``b40``: the same with 40 seeds; against the 40 JAX seeds pooled from
  ``parity_nlink.json``, ``parity_nlink_b.json`` and ``parity_nlink_c.json``
  (every env on one episode clock, as all three were run).
- ``b_single``: the same 10 seeds in turn, each its own ``OnPolicyRunner``
  (as the JAX arm ran them); against ``parity_nlink.json``. ``b40_single``:
  40 of them against the three pooled files.
- ``b_desync``: the same with 10 seeds and each env's episode clock
  scattered once at the start (``parity_nlink.py --random-ep-len``); against
  ``parity_nlink_desync.json``.
- ``c``: RND Pendulum, 6 seeds in turn (``OnPolicyRunner``, 64 ``Pendulum``
  envs, ``max_episode_length=200``), the extrinsic reward
  (``ep_ereward_sum``); against ``parity_pendulum_rnd.json``.
- ``d``: symmetry PointMass, 10 seeds in turn (64 ``PointMass`` envs,
  ``max_episode_length=100``, data augmentation), 300 iterations; against
  ``parity_symmetry.json``.
- ``e``: the recurrent partially observed Pendulum, 10 seeds in turn (64
  ``PartiallyObservablePendulum`` envs, ``max_episode_length=200``,
  ``train_cfg(seed, recurrent=True)``: GRU-64, [128] heads), 400
  iterations; against ``parity_pendulum_recurrent.json`` (5 JAX seeds).
- ``f`` and ``f_rec``: distillation (``benchmarks/parity_distillation.py``'s
  ``distill_cfg``), 10 seeds in turn of 64 ``Pendulum`` envs (a [128, 128]
  student cloning a [128, 128] teacher on the same obs) and of 64
  ``PrivilegedPendulum`` envs (a GRU-64 student on ``[cos, sin]`` cloning a
  teacher that sees the velocity), 200 and 300 iterations; the study value
  is the student's reward. The teachers are the JAX package's, trained by
  ``parity_jax_teacher.py`` and committed in the reference's checkpoint
  layout (``parity_teachers/``); the port reads one with
  ``utils/torch_deploy.py::import_torch_checkpoint`` into the teacher's own
  ``ActorCritic`` and hands its actor to the student-teacher
  (``load_policy_state``: the ``actor -> teacher`` remap). The decision is
  against the JAX students from the same teachers
  (``parity_jax_distill_results.json``); the committed files
  (``parity_distillation{,_recurrent}.json``, from an earlier teacher) are
  held beside them (``jax_committed``).

The port draws from Philox and splitmix64 where JAX draws from threefry, and
a study's seeds are its own (a multi-seed study draws its seeds' inits from
its one ``seed``), so only the bands compare, never a curve seed by seed.
Per study the script prints and stores the port's per-seed finals, their
mean, std and median, Welch's t and Mann-Whitney U p-values against the JAX
finals, the checkpoint table at the JAX file's iterations, the wall seconds
and the card's name and power limit. It writes ``parity_torch_results.json``
(curves included) at the root of the repository. ``--iterations`` shortens
every study (a rehearsal; the protocol's counts are the default), and
``--device cpu`` runs a rehearsal on the CPU. ``--seed-offset K`` runs seeds
``K + 1 ..`` (a single-seed study's runners; a multi-seed study's one
seed) and stores the study as ``<name>_s<K + 1>``; ``--pool NAME NAME ...
--as POOLED`` pools stored studies of one protocol (their per-seed finals
and curves) into ``POOLED`` without running anything.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from rsl_rl_tpu_torch.env import (
    NLinkPendulum,
    PartiallyObservableNLink,
    PartiallyObservablePendulum,
    Pendulum,
    PointMass,
    PrivilegedPendulum,
)
from rsl_rl_tpu_torch.modules import ActorCritic
from rsl_rl_tpu_torch.runners import DistillationRunner, MultiSeedRunner, OnPolicyRunner
from rsl_rl_tpu_torch.utils.torch_deploy import import_torch_checkpoint

ROOT = os.path.dirname(os.path.abspath(__file__))
RESULTS = os.path.join(ROOT, "benchmarks", "results")
OUT = os.path.join(ROOT, "parity_torch_results.json")
#: the JAX teachers of the distillation studies (``parity_jax_teacher.py``),
#: in the reference's checkpoint layout, and the JAX students from them
TEACHERS = os.path.join(ROOT, "parity_teachers")
TEACHER_FILES = {False: "teacher_ref.pt", True: "teacher_privileged_ref.pt"}
JAX_DISTILL = "parity_jax_distill_results.json"
FINAL_WINDOW = 20
LAGGARD_THRESHOLD = -250.0
NUM_ENVS = 64


def train_cfg(seed: int, recurrent: bool = False, rnd: bool = False) -> dict:
    """``benchmarks/parity_pendulum.py``'s ``train_cfg``, the config of the
    NLink and Pendulum studies."""
    policy = {"class_name": "ActorCritic", "activation": "elu", "actor_obs_normalization": True,
              "critic_obs_normalization": True, "actor_hidden_dims": [128, 128], "critic_hidden_dims": [128, 128],
              "init_noise_std": 1.0}
    if recurrent:
        policy.update(class_name="ActorCriticRecurrent", rnn_type="gru", rnn_hidden_dim=64,
                      actor_hidden_dims=[128], critic_hidden_dims=[128])
    obs_groups = {"policy": ["policy"], "critic": ["policy"]}
    if rnd:
        obs_groups["rnd_state"] = ["policy"]
    algorithm = {"class_name": "PPO", "learning_rate": 1.0e-3, "num_learning_epochs": 5, "num_mini_batches": 4,
                 "schedule": "adaptive", "desired_kl": 0.01, "gamma": 0.99, "lam": 0.95, "clip_param": 0.2,
                 "entropy_coef": 0.01, "value_loss_coef": 1.0, "max_grad_norm": 1.0,
                 "use_clipped_value_loss": True}
    if rnd:
        algorithm["rnd_cfg"] = {"weight": 0.5, "num_outputs": 16, "predictor_hidden_dims": [-1],
                                "target_hidden_dims": [-1], "state_normalization": True,
                                "reward_normalization": True, "learning_rate": 1.0e-3}
    return {"num_steps_per_env": 24, "save_interval": 10_000, "seed": seed, "obs_groups": obs_groups,
            "policy": policy, "algorithm": algorithm, "fuse_iteration": True}


def distill_cfg(seed: int, recurrent: bool = False) -> dict:
    """``benchmarks/parity_distillation.py``'s ``distill_cfg``: a [128, 128]
    student cloning a [128, 128] teacher on the same obs, or a GRU-64 student
    with a [128] head on ``policy`` cloning a teacher on ``privileged``."""
    policy = {"class_name": "StudentTeacher", "student_hidden_dims": [128, 128], "teacher_hidden_dims": [128, 128],
              "student_obs_normalization": True, "teacher_obs_normalization": True, "init_noise_std": 0.1}
    obs_groups = {"policy": ["policy"], "teacher": ["policy"]}
    if recurrent:
        policy.update(class_name="StudentTeacherRecurrent", rnn_type="gru", rnn_hidden_dim=64,
                      student_hidden_dims=[128])
        obs_groups = {"policy": ["policy"], "teacher": ["privileged"]}
    algorithm = {"class_name": "Distillation", "learning_rate": 1.0e-3, "gradient_length": 8,
                 "num_learning_epochs": 1, "max_grad_norm": 1.0}
    return {"num_steps_per_env": 24, "save_interval": 10_000, "seed": seed, "obs_groups": obs_groups,
            "policy": policy, "algorithm": algorithm, "fuse_iteration": True}


def load_reference_teacher(runner, path: str) -> None:
    """Hand the teacher of a reference-layout RL checkpoint to ``runner``'s
    student-teacher: the checkpoint goes through
    :func:`import_torch_checkpoint` into an ``ActorCritic`` built as the
    teacher was trained (``train_cfg(0)``'s policy on the teacher's obs set),
    whose actor and actor normalizer the student-teacher takes as its teacher
    (``load_policy_state``, the ``actor -> teacher`` remap of the JAX
    ``DistillationRunner.load``)."""
    student = runner.alg.policy
    groups = runner.cfg["obs_groups"]["teacher"]
    obs = {k: v.cpu() for k, v in runner.collect_state.obs.items()}
    teacher_cfg = {k: v for k, v in train_cfg(0)["policy"].items() if k != "class_name"}
    teacher = ActorCritic(obs, {"policy": groups, "critic": groups}, runner.env.num_actions, device="cpu",
                          **teacher_cfg)
    import_torch_checkpoint(teacher, path)
    if student.load_policy_state(teacher.state_dict()):
        raise ValueError(f"{path} restored a student instead of handing over a teacher")


def symmetry_cfg(seed: int) -> dict:
    """``benchmarks/parity_symmetry.py``'s ``train_cfg`` with the port's
    augmentation function."""
    cfg = train_cfg(seed)
    cfg["algorithm"]["symmetry_cfg"] = {
        "use_data_augmentation": True, "use_mirror_loss": False,
        "data_augmentation_func": "rsl_rl_tpu_torch.env.toy:point_mass_symmetry", "mirror_loss_coeff": 0.0}
    return cfg


#: name -> (description, JAX result file (or files pooled), iterations, seeds,
#: reward key, scattered episode lengths): the JAX studies' own protocols. The pooled recurrent study
#: scattered each env's episode clock once at the start (``parity_nlink.py
#: --recurrent --random-ep-len``, ``init_at_random_ep_len``); ``a_sync`` is the
#: same task with every env on one clock, against the JAX package's synchronized
#: 20-seed run; the feedforward studies ran synchronized, but for the
#: desynchronized one (``parity_nlink.py --random-ep-len``).
STUDIES = {
    "a": ("recurrent NLink, GRU-64, scattered episode clocks", "parity_nlink_recurrent_pooled.json", 500, 40,
          "ep_reward_sum", True),
    "a_sync": ("recurrent NLink, GRU-64, one episode clock", "parity_nlink_recurrent_sync20.json", 500, 40,
               "ep_reward_sum", False),
    "b": ("feedforward NLink, [128, 128]", "parity_nlink.json", 500, 10, "ep_reward_sum", False),
    "b40": ("feedforward NLink, [128, 128], 40 seeds", ("parity_nlink.json", "parity_nlink_b.json",
                                                        "parity_nlink_c.json"), 500, 40, "ep_reward_sum", False),
    "b_single": ("feedforward NLink, [128, 128], single-seed runners", "parity_nlink.json", 500, 10,
                 "ep_reward_sum", False),
    "b40_single": ("feedforward NLink, [128, 128], 40 single-seed runners", ("parity_nlink.json",
                   "parity_nlink_b.json", "parity_nlink_c.json"), 500, 40, "ep_reward_sum", False),
    "b_desync": ("feedforward NLink, [128, 128], scattered episode clocks", "parity_nlink_desync.json", 500, 10,
                 "ep_reward_sum", True),
    "c": ("RND Pendulum", "parity_pendulum_rnd.json", 500, 6, "ep_ereward_sum", False),
    "d": ("symmetry PointMass", "parity_symmetry.json", 300, 10, "ep_reward_sum", False),
    "e": ("recurrent partially observed Pendulum, GRU-64", "parity_pendulum_recurrent.json", 400, 10,
          "ep_reward_sum", False),
    "f": ("distillation Pendulum, [128, 128] student, the student's reward", JAX_DISTILL, 200, 10,
          "ep_reward_sum", False),
    "f_rec": ("distillation PrivilegedPendulum, GRU-64 student on [cos, sin], the student's reward", JAX_DISTILL,
              300, 10, "ep_reward_sum", False),
}
#: the distillation studies: (recurrent student, the committed JAX file)
DISTILL_STUDIES = {"f": (False, "parity_distillation.json"), "f_rec": (True, "parity_distillation_recurrent.json")}
#: the checkpoint iterations of the JAX files that carry none
DISTILL_CHECKPOINTS = (25, 50, 100, 150, 200, 300)


def curve_point(metrics: dict, key: str):
    """An iteration's mean reward over its completed episodes (nan if none),
    per seed for a study's ``[G]`` metrics."""
    count = np.asarray(metrics["ep_count"], np.float64)
    total = np.asarray(metrics[key], np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(count > 0, total / np.where(count > 0, count, 1.0), np.nan)


def quiet_learn(runner, iterations: int) -> None:
    """``runner.learn`` without its console log (one block an iteration)."""
    with contextlib.redirect_stdout(io.StringIO()):
        runner.learn(iterations)


def study_runner(name: str, seed: int, device: str):
    """The runner of one seed of a single-seed study, teacher loaded."""
    if name in ("b_single", "b40_single"):
        return OnPolicyRunner(NLinkPendulum(NUM_ENVS, num_links=5, max_episode_length=400, device=device),
                              train_cfg(seed), device=device)
    if name == "c":
        return OnPolicyRunner(Pendulum(NUM_ENVS, max_episode_length=200, device=device), train_cfg(seed, rnd=True),
                              device=device)
    if name == "d":
        return OnPolicyRunner(PointMass(NUM_ENVS, max_episode_length=100, device=device), symmetry_cfg(seed),
                              device=device)
    if name == "e":
        return OnPolicyRunner(PartiallyObservablePendulum(NUM_ENVS, max_episode_length=200, device=device),
                              train_cfg(seed, recurrent=True), device=device)
    recurrent = DISTILL_STUDIES[name][0]
    env_cls = PrivilegedPendulum if recurrent else Pendulum
    runner = DistillationRunner(env_cls(NUM_ENVS, max_episode_length=200, device=device),
                                distill_cfg(seed, recurrent), device=device)
    load_reference_teacher(runner, os.path.join(TEACHERS, TEACHER_FILES[recurrent]))
    return runner


def run_study(name: str, iterations: int, device: str, seed_offset: int = 0) -> np.ndarray:
    """The port's curves ``[seeds, iterations]`` of one study, of the seeds
    ``seed_offset + 1 ..``."""
    _, _, _, seeds, key, scatter = STUDIES[name]
    if name in ("a", "a_sync", "b", "b40", "b_desync"):
        recurrent = name.startswith("a")
        env_cls = PartiallyObservableNLink if recurrent else NLinkPendulum
        env = env_cls(NUM_ENVS, num_links=5, max_episode_length=400, device=device)
        runner = MultiSeedRunner(env, train_cfg(1 + seed_offset, recurrent=recurrent), seeds, device=device)
        if scatter:  # every seed's envs, as each JAX run's init_at_random_ep_len
            runner.collect_state.env_state = env.randomize_episode_length(runner.collect_state.env_state)
        quiet_learn(runner, iterations)
        return np.stack([curve_point(h["metrics"], key) for h in runner.history], axis=1)
    curves = []
    for seed in range(seed_offset + 1, seed_offset + seeds + 1):
        runner = study_runner(name, seed, device)
        quiet_learn(runner, iterations)
        curves.append([float(curve_point(h["metrics"], key)) for h in runner.history])
        print(f"study {name} seed {seed}: final {finals(np.asarray([curves[-1]]))[0]:.1f}", flush=True)
    return np.asarray(curves)


def window_means(curves: np.ndarray, it: int) -> np.ndarray:
    """Each seed's nan-aware mean over the ``FINAL_WINDOW`` iterations up to
    ``it`` (nan where none of them completed an episode)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # a window without episodes
        return np.nanmean(curves[:, max(0, it - FINAL_WINDOW):it], axis=1)


def finals(curves: np.ndarray) -> np.ndarray:
    """Each seed's nan-aware mean over the trailing ``FINAL_WINDOW`` iterations."""
    return window_means(curves, curves.shape[1])


def band(values: np.ndarray) -> dict:
    return {"mean": float(np.mean(values)), "std": float(np.std(values)), "median": float(np.median(values)),
            "min": float(np.min(values)), "max": float(np.max(values)),
            "laggards_below_-250": int(np.sum(values < LAGGARD_THRESHOLD)),
            "per_seed": [float(v) for v in values]}


def jax_finals(path, name: str | None = None) -> tuple[np.ndarray, list[dict]]:
    """The JAX package's per-seed finals and checkpoint rows of a study file;
    of several files, their seeds pooled, with the rows (mean and std of the
    trailing-window means) computed from the pooled curves; of the JAX
    students' file (``parity_jax_distill_results.json``, at the root), study
    ``name``'s curves, with the rows computed from them."""
    if path == JAX_DISTILL:
        with open(os.path.join(ROOT, path)) as f:
            curves = np.asarray([[np.nan if v is None else v for v in c]
                                 for c in json.load(f)["studies"][name]["curves"]], np.float64)
        rows = [{"iteration": r["iteration"], "rsl_rl_tpu": r["port"], "rsl_rl_tpu_std": r["port_std"]}
                for r in checkpoints(curves, list(DISTILL_CHECKPOINTS))]
        return finals(curves), rows
    if not isinstance(path, str):
        curves = []
        for part in path:
            with open(os.path.join(RESULTS, part)) as f:
                data = json.load(f)
            curves += data["curves"]["rsl_rl_tpu"]
            iterations = [row["iteration"] for row in data["checkpoints"]]
        curves = np.asarray(curves, np.float64)
        rows = [{"iteration": r["iteration"], "rsl_rl_tpu": r["port"], "rsl_rl_tpu_std": r["port_std"]}
                for r in checkpoints(curves, iterations)]
        return finals(curves), rows
    with open(os.path.join(RESULTS, path)) as f:
        data = json.load(f)
    if "finals" in data:  # the pooled 40-seed study stores its finals
        ours = np.asarray(data["finals"]["rsl_rl_tpu"]["per_seed"], np.float64)
    else:  # the distillation files name their curves reward_curves
        curves = data["curves"] if "curves" in data else data["reward_curves"]
        ours = finals(np.asarray(curves["rsl_rl_tpu"], np.float64))
    rows = [{k: v for k, v in row.items() if k == "iteration" or k.startswith("rsl_rl_tpu")}
            for row in data["checkpoints"]]
    return ours, rows


def p_values(port: np.ndarray, jax_: np.ndarray) -> dict:
    """Welch's t and two-sided Mann-Whitney U p-values of two sets of finals."""
    from scipy import stats

    return {"welch_t_p": float(stats.ttest_ind(port, jax_, equal_var=False).pvalue),
            "mann_whitney_u_p": float(stats.mannwhitneyu(port, jax_, alternative="two-sided").pvalue)}


def pool_studies(results: dict, names: list[str], pooled: str) -> dict:
    """One study of the stored studies ``names`` of one protocol (their seeds
    and curves pooled, against the same JAX finals)."""
    parts = [results["studies"][n] for n in names]
    if len({(json.dumps(p["jax_file"]), p["iterations"]) for p in parts}) != 1:
        raise ValueError(f"{names} are not studies of one protocol")
    curves = np.asarray([[np.nan if v is None else v for v in c] for p in parts for c in p["curves"]], np.float64)
    port = finals(curves)
    jax_ = np.asarray(parts[0]["jax"]["per_seed"], np.float64)
    study = {**{k: parts[0][k] for k in ("description", "jax_file", "iterations", "reward_key",
                                         "scattered_episode_clocks", "window_iters", "card")},
             "pooled_from": names, "seeds": len(port),
             "seed_list": [s for p in parts for s in p.get("seed_list", range(1, p["seeds"] + 1))],
             "wall_s": sum(p["wall_s"] for p in parts), "port": band(port), "jax": parts[0]["jax"],
             **p_values(port, jax_),
             "checkpoints": {"port": checkpoints(curves, [r["iteration"] for r in parts[0]["checkpoints"]["jax"]]),
                             "jax": parts[0]["checkpoints"]["jax"]},
             "curves": [[None if math.isnan(v) else float(v) for v in c] for c in curves]}
    results["studies"][pooled] = study
    return study


def checkpoints(curves: np.ndarray, iterations: list[int]) -> list[dict]:
    """The port's mean, std and median of the trailing-window means at the
    JAX file's checkpoint iterations."""
    rows = []
    for it in iterations:
        if it > curves.shape[1]:
            continue
        v = window_means(curves, it)
        v = v[~np.isnan(v)]
        if len(v):
            rows.append({"iteration": it, "port": float(v.mean()), "port_std": float(v.std()),
                         "port_median": float(np.median(v))})
    return rows


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu (no card)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def report(name: str, study: dict) -> None:
    summary = {k: study[k] for k in ("description", "iterations", "seeds", "wall_s", "welch_t_p",
                                     "mann_whitney_u_p")}
    summary.update({f"{side}_{k}": study[side][k] for side in ("port", "jax")
                    for k in ("mean", "std", "median", "laggards_below_-250")})
    print(f"study {name}: " + json.dumps(summary), flush=True)
    print(f"study {name} port per-seed finals: {[round(v, 1) for v in study['port']['per_seed']]}")
    if "jax_committed" in study:
        committed = study["jax_committed"]
        print(f"study {name} against {committed['file']}: " + json.dumps(
            {"jax_mean": committed["band"]["mean"], "jax_std": committed["band"]["std"],
             "welch_t_p": committed["welch_t_p"], "mann_whitney_u_p": committed["mann_whitney_u_p"]}))
    for row_port in study["checkpoints"]["port"]:
        row_jax = next((r for r in study["checkpoints"]["jax"] if r["iteration"] == row_port["iteration"]), {})
        print(f"study {name} checkpoint {json.dumps({**row_port, **{'jax_' + k: v for k, v in row_jax.items() if k != 'iteration'}})}")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--studies", nargs="+", default=sorted(STUDIES), choices=sorted(STUDIES))
    p.add_argument("--iterations", type=int, default=None, help="shorten every study (a rehearsal)")
    p.add_argument("--seed-offset", type=int, default=0,
                   help="run seeds OFFSET+1..; the study is stored as <name>_s<OFFSET+1>")
    p.add_argument("--pool", nargs="+", metavar="NAME", help="pool these stored studies (runs nothing)")
    p.add_argument("--as", dest="pooled", help="the pooled study's name")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=OUT)
    args = p.parse_args()
    results = {"studies": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    if args.pool:
        if not args.pooled:
            p.error("--pool needs --as")
        report(args.pooled, pool_studies(results, args.pool, args.pooled))
        with open(args.out, "w") as f:
            json.dump(results, f)
        return
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("parity_torch: torch.cuda.is_available() is false")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    smi = card()
    print(smi, flush=True)
    results.update({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    for name in args.studies:
        desc, path, iterations, seeds, key, scatter = STUDIES[name]
        iterations = args.iterations or iterations
        start = time.perf_counter()
        curves = run_study(name, iterations, args.device, args.seed_offset)
        wall = time.perf_counter() - start
        port = finals(curves)
        jax_, jax_rows = jax_finals(path, name)
        study = {
            "description": desc,
            "jax_file": [path if path == JAX_DISTILL else f"benchmarks/results/{p}"
                         for p in ([path] if isinstance(path, str) else path)],
            "iterations": iterations,
            "seeds": seeds, "seed_list": list(range(args.seed_offset + 1, args.seed_offset + seeds + 1)),
            "reward_key": key, "scattered_episode_clocks": scatter, "window_iters": FINAL_WINDOW,
            "wall_s": wall, "card": smi,
            "port": band(port), "jax": band(jax_),
            **p_values(port, jax_),
            "checkpoints": {"port": checkpoints(curves, [r["iteration"] for r in jax_rows]), "jax": jax_rows},
            "curves": [[None if math.isnan(v) else float(v) for v in c] for c in curves],
        }
        if name in DISTILL_STUDIES:  # the committed JAX files, from an earlier teacher
            committed = DISTILL_STUDIES[name][1]
            jax_c, _ = jax_finals(committed)
            study["jax_committed"] = {"file": f"benchmarks/results/{committed}", "band": band(jax_c),
                                      **p_values(port, jax_c)}
        stored = name if args.seed_offset == 0 else f"{name}_s{args.seed_offset + 1}"
        results["studies"][stored] = study
        report(stored, study)
        with open(args.out, "w") as f:
            json.dump(results, f)
    print(json.dumps({"parity": {k: {"welch_t_p": v["welch_t_p"], "mann_whitney_u_p": v["mann_whitney_u_p"],
                                     "port_mean": v["port"]["mean"], "jax_mean": v["jax"]["mean"]}
                                 for k, v in results["studies"].items()}, "card": smi}))


if __name__ == "__main__":
    main()
