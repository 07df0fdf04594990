"""The benchmark of ``rsl_rl_tpu_torch``: one cell, one run.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, ``configs/<config>.json`` (the env, the runner's
``train_cfg`` and its precision), and a traffic mix,
``mixes/<traffic>.json`` (the dispatch, the ranks, the envs a rank, the
iterations the trace covers); ``limits/<cell>.json`` holds the limits of
the numbers that decide ``correct``, and every metric is read by
``metrics/<metric>.py``; the reference follows a recurrent policy's memory
through ``reference/cells/<rnn_type>.py``. A run builds the port's
``OnPolicyRunner`` from those files and the seed, hands it weights made
from the seed on the device, drives it through the checked steps (the
window's own call, ``learn``), warm, then through ``learn`` for the window,
optionally traces a steady stretch after it, and finally runs the plain reference
(``reference/``) over the checked steps from the same weights and draws.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "rsl_rl_tpu_torch"
#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "rsl_rl_tpu")
#: the program's first steps, which the reference follows
CHECK_STEPS = 3


class SpecError(ValueError):
    """A cell, configuration, mix, limit or metric file that is missing or malformed."""


def _read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def load_spec(cell_name: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, mix and limits, the reference's
    memory family (``memory``: :func:`load_memory`), and the metrics that
    apply to it (``end_to_end`` and ``per_layer``, each entry with its reader)."""
    bench = _read_json(root / "BENCHMARK.json", "the benchmark")
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise SpecError(f"no workload {cell_name!r} in BENCHMARK.json (has {sorted(cells)})")
    cell = cells[cell_name]
    base = root / "portbench"
    config = _read_json(base / "configs" / f"{cell['config']}.json", f"configuration {cell['config']}")
    spec = {
        "cell": cell,
        "config": config,
        "memory": load_memory(config["train_cfg"]["policy"], root),
        "mix": _read_json(base / "mixes" / f"{cell['traffic']}.json", f"traffic {cell['traffic']}"),
        "limits": _read_json(base / "limits" / f"{cell_name}.json", f"limits of {cell_name}"),
        "run_seconds": bench["run_seconds"],
    }
    for kind in ("end_to_end", "per_layer"):
        spec[kind] = [dict(m, read=load_reader(m["name"], root)) for m in bench[kind]
                      if cell_name in m.get("workloads", [cell_name])]
    return spec


def load_reader(metric: str, root: Path = ROOT):
    """``read(ctx) -> float | None`` of ``metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"metric {metric}: no reader {path}")
    return _load_module(f"portbench_metric_{metric}", path).read


def load_memory(policy: dict, root: Path = ROOT):
    """The reference's memory family of a recurrent ``policy``, the module
    ``reference/cells/<rnn_type>.py`` (the port's default ``rnn_type`` is
    ``lstm``); None for a feedforward one.

    Raises a :class:`SpecError` where the reference cannot follow the
    policy: stacked memories, no file for the family, or a dtype the
    family's ``step`` refuses (one step at width 1 on the CPU asks it)."""
    if policy["class_name"] != "ActorCriticRecurrent":
        return None
    layers = policy.get("rnn_num_layers", 1)
    if layers != 1:
        raise SpecError(f"rnn_num_layers {layers}: the reference follows a single memory layer")
    rnn_type = policy.get("rnn_type", "lstm").lower()
    path = root / "portbench" / "reference" / "cells" / f"{rnn_type}.py"
    if not path.is_file():
        raise SpecError(f"memory {rnn_type}: no reference cell {path}")
    memory = _load_module(f"portbench_cell_{rnn_type}", path)
    import torch

    from portbench.reference.ppo import dtype_of

    P = {leaf: torch.zeros(shape) for leaf, shape, _ in memory.layout(1, 1)}
    memory.step(P, memory.zeros(1, 1, "cpu"), torch.zeros(1, 1), dtype_of(policy.get("dtype")), lambda t: t)
    return memory


def _load_module(name: str, path: Path):
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def import_program(root: Path = ROOT):
    """Import the port from the checkout at ``root``; raise if it is missing
    there (the benchmark never falls back to another installation)."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import rsl_rl_tpu_torch

    where = Path(rsl_rl_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise SpecError(f"{PROGRAM} was imported from {where}, not from the checkout {root}")
    return rsl_rl_tpu_torch


@dataclass
class Context:
    """What a metric's reader reads (``metrics/*.py``)."""

    spec: dict
    chips: int
    num_envs: int  # every rank's envs
    obs_dim: int
    num_actions: int
    setup_s: float
    window_s: float
    iterations: int
    env_steps: int
    iteration_s: list
    loop_s: float  # the window's seconds inside the iterations' own timers
    launches: int | None  # memory-replay kernel launches in the window
    capture_s: float | None
    device_name: str
    traces: list = field(default_factory=list)  # one summary a rank (portbench/trace.py)
    trace_iterations: int = 0


def train_cfg(spec: dict, seed: int) -> dict:
    """The runner's config: the configuration's, seeded, with the mix's dispatch."""
    import torch

    cfg = copy.deepcopy(spec["config"]["train_cfg"])
    cfg["seed"] = int(seed)
    dtype = cfg["policy"].get("dtype")
    if dtype is not None:
        cfg["policy"]["dtype"] = getattr(torch, dtype)
    mix = spec["mix"]
    cfg["fuse_iteration"] = mix["dispatch"] == "graphed"
    cfg["iterations_per_dispatch"] = mix.get("iterations_per_dispatch", 1)
    return cfg


def set_precision(control: str | None = None) -> None:
    """torch's TF32 switches as the configurations state (off), or on for the TF32 control."""
    import torch

    tf32 = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def launch_total() -> int:
    from rsl_rl_tpu_torch.utils.cuda_graph import launch_counters

    return sum(c.fwd_launches + c.bwd_launches + c.wgrad_launches for c in launch_counters())


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port's runner of one cell, built from the seed with the
    benchmark's weights, and the calls the run drives it through."""

    def __init__(self, spec: dict, seed: int, device, num_envs: int, weights: dict):
        import torch

        import_program()
        from rsl_rl_tpu_torch.runners import OnPolicyRunner
        from rsl_rl_tpu_torch.utils.registry import resolve

        env_cfg = spec["config"]["env"]
        env = resolve("env", env_cfg["class_name"])(num_envs, env_cfg["num_links"], env_cfg["max_episode_length"],
                                                    device=device)
        self.runner = OnPolicyRunner(env, train_cfg(spec, seed), log_dir=None, device=device)
        self.device = device
        with torch.no_grad():
            for name, p in self.runner.alg.policy.named_parameters():
                p.copy_(weights[name])

    def check_steps(self, random_episode_lengths: bool) -> list:
        """The checked steps, each a ``learn(1)`` (the first scatters the
        episode lengths where the mix says so): ``[(losses, state)]`` a step
        (:func:`program_snapshot`)."""
        runner = self.runner
        snaps = []
        for k in range(CHECK_STEPS):
            runner.learn(1, init_at_random_ep_len=random_episode_lengths and k == 0)
            snaps.append(program_snapshot(runner))
        losses = [{k.removeprefix("Loss/"): float(v) for k, v in row["metrics"].items() if k.startswith("Loss/")}
                  for row in runner.history[:CHECK_STEPS]]
        return list(zip(losses, snaps))

    def warm_up(self, iterations: int) -> float:
        """``learn(iterations)`` timed as the window is; the median seconds
        of an iteration (a stall in a few iterations does not shorten the
        window that follows)."""
        times = sorted(self.window(iterations)["iteration_s"])
        return times[len(times) // 2]

    def window(self, iterations: int) -> dict:
        """``learn(iterations)``, timed on the host clock and ended by a
        synchronize: the wall seconds, each iteration's seconds (from the end
        of the one before, when the runner logs it), the seconds inside the
        iterations' own timers, the launches and the failed iterations."""
        runner = self.runner
        stamps = []
        log = runner._log

        def timed_log(*args, **kwargs):
            stamps.append(time.perf_counter())
            return log(*args, **kwargs)

        runner._log = timed_log
        first = len(runner.history)
        launches = launch_total()
        sync(self.device)
        t0 = time.perf_counter()
        try:
            runner.learn(iterations)
            sync(self.device)
            t1 = time.perf_counter()
        finally:
            del runner._log
        rows = runner.history[first:]
        ends = [t0, *stamps]
        failed = sum(1 for r in rows if not all(math.isfinite(v) for k, v in r["metrics"].items() if k.startswith("Loss/")))
        return {"t0": t0, "wall_s": t1 - t0, "iteration_s": [b - a for a, b in zip(ends[:-1], ends[1:])],
                "loop_s": sum(r["collection_s"] + r["learn_s"] for r in rows), "launches": launch_total() - launches,
                "iterations": len(rows), "failed": failed}

    def trace(self, iterations: int) -> dict:
        from portbench.trace import trace_stretch

        runner = self.runner
        spans = {"runner.log": (runner, "_log"), "alg.collect": (runner.alg, "collect"),
                 "alg.update": (runner.alg, "update")}
        if runner.iteration_graph is not None:
            spans.update({"dispatch.replay": (runner.iteration_graph, "run"),
                          "dispatch.read_metrics": (runner.iteration_graph, "unpack")})
        return trace_stretch(lambda: runner.learn(iterations), spans, self.device)


def program_snapshot(runner) -> dict:
    """The program's training state between iterations, in the form of the
    reference's ``snapshot`` (copies). On a mesh the per-env parts (env
    state, obs, carry) are every rank's shards in rank order; the rest is
    replicated. Every rank takes part."""
    from portbench.reference.ppo import clone_tree, map_carry

    alg, policy, cs = runner.alg, runner.alg.policy, runner.collect_state
    opt, buffers = alg.optimizer_state(), policy.state_dict()
    carry = None
    if policy.is_recurrent:
        carry = {"actor": cs.carry["actor"][0], "critic": cs.carry["critic"][0]}
    rows = _gather_rows if runner.mesh is not None and runner.mesh.distributed else (lambda t: t)
    return clone_tree({
        "params": dict(policy.named_parameters()), "mu": opt["mu"], "nu": opt["nu"], "count": opt["count"],
        "lr": alg.lr, "obs": rows(cs.obs["policy"]),
        "carry": None if carry is None else {k: map_carry(rows, v) for k, v in carry.items()},
        "norms": {w: [buffers[f"norm_{w}.{k}"] for k in ("mean", "var", "count")] for w in ("actor", "critic")},
        "env": {k: rows(getattr(cs.env_state, k)) for k in ("theta", "omega", "rng", "episode_length")},
    })


def _gather_rows(t):
    """Every rank's ``t`` concatenated along the env axis, in rank order."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def reference(spec: dict, seed: int, device, num_envs: int, weights: dict, control: str | None = None,
              half_batch: bool = False, parts: int = 1):
    """The plain reference of the cell from the start (``control``:
    ``"tf32"`` or ``"fp8"``, the lower precision; ``half_batch``: the
    planted fault; ``parts``: gradients summed over that many data ranks'
    shares, the witness of a mesh's reordering)."""
    from portbench.reference.ppo import ReferencePPO

    config = spec["config"]
    return ReferencePPO(config["train_cfg"], config["env"], num_envs, weights, seed, device, spec["memory"],
                        random_episode_lengths=spec["mix"].get("init_at_random_ep_len", False),
                        operand="fp8" if control == "fp8" else None, half_batch=half_batch, parts=parts)


def follow(spec: dict, seed: int, device, num_envs: int, weights: dict, states: list) -> list:
    """The reference's checked steps: the first from the start, each later
    one from the state the compared side reached before it (``states``,
    one a step); ``[(losses, state)]`` a step."""
    set_precision()
    ref = reference(spec, seed, device, num_envs, weights)
    steps = []
    for k in range(CHECK_STEPS):
        if k:
            ref.load_state(states[k - 1])
        losses = ref.iteration()
        steps.append((losses, ref.snapshot()))
    return steps


def free_run(spec: dict, seed: int, device, num_envs: int, weights: dict, control: str | None = None,
             half_batch: bool = False, parts: int = 1) -> list:
    """The checked steps of a reference put in the program's place (the
    control, a planted fault or the mesh's witness): ``[(losses, state)]`` a step."""
    set_precision(control)
    try:
        ref = reference(spec, seed, device, num_envs, weights, control, half_batch, parts)
        return [(ref.iteration(), ref.snapshot()) for _ in range(CHECK_STEPS)]
    finally:
        set_precision()


def check_numbers(spec: dict, seed: int, device, num_envs: int, weights: dict, steps: list) -> dict:
    """The check's numbers of the compared side's ``steps``."""
    from portbench.check import compare

    ref = follow(spec, seed, device, num_envs, weights, [state for _, state in steps])
    return compare(steps, ref, weights, spec["config"]["train_cfg"]["algorithm"])


def make_cell_weights(spec: dict, seed: int, device) -> tuple[dict, int, int]:
    """The cell's initial weights from its seed, with the obs and action widths."""
    from portbench.reference.ppo import make_weights, param_layout

    L = spec["config"]["env"]["num_links"]
    obs_dim, num_actions = 3 * L, L
    layout = param_layout(spec["config"]["train_cfg"], obs_dim, num_actions, spec["memory"])
    return make_weights(layout, seed, device), obs_dim, num_actions


def run_rank(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float, mesh_init=None,
             num_envs: int | None = None, fault=None) -> dict:
    """One rank's run (the whole run on one chip): set-up, checked steps,
    window, optional trace, then (rank 0) the reference. Returns the
    rank's readings; ``fault(program)`` plants a fault (tests only)."""
    import torch

    mix, config = spec["mix"], spec["config"]
    ranks = mix.get("ranks", 1)
    rank = 0 if mesh_init is None else mesh_init["rank"]
    envs_global = (num_envs or mix["envs_per_rank"]) * ranks
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    set_precision()
    import_program()
    if mesh_init is not None:
        from rsl_rl_tpu_torch.parallel.mesh import distributed_init

        distributed_init(**mesh_init)
    weights, obs_dim, num_actions = make_cell_weights(spec, seed, device)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        program = Program(spec, seed, device, envs_global, weights)
        if fault is not None:
            fault(program)
        steps = program.check_steps(mix.get("init_at_random_ep_len", False))
        iterations = max(1, math.ceil(seconds / program.warm_up(mix["warmup_iterations"])))
        if mesh_init is not None:
            iterations = _agree_max(iterations, device)
        window = program.window(iterations)
        setup_s = window["t0"] - t_start
        summary = program.trace(mix["trace_iterations"]) if trace else None
        capture_s = None if program.runner.iteration_graph is None else program.runner.iteration_graph.capture_s
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if mesh_init is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    out = {"setup_s": setup_s, "window": window, "trace": summary, "capture_s": capture_s, "peak": peak,
           "obs_dim": obs_dim, "num_actions": num_actions, "envs_global": envs_global}
    if rank == 0:
        out["numbers"] = check_numbers(spec, seed, device, envs_global, weights, steps)
    return out


def _agree_max(n: int, device) -> int:
    import torch
    import torch.distributed as dist

    t = torch.tensor([n], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def context(spec: dict, ranks: list[dict], device_name: str) -> Context:
    """The readers' context from every rank's readings (rank 0 first)."""
    lead = ranks[0]
    w = lead["window"]
    cfg = spec["config"]["train_cfg"]
    return Context(
        spec=spec, chips=spec["cell"]["chips"], num_envs=lead["envs_global"], obs_dim=lead["obs_dim"],
        num_actions=lead["num_actions"], setup_s=max(r["setup_s"] for r in ranks), window_s=w["wall_s"],
        iterations=w["iterations"], env_steps=w["iterations"] * cfg["num_steps_per_env"] * lead["envs_global"],
        iteration_s=w["iteration_s"], loop_s=w["loop_s"], launches=w["launches"], capture_s=lead["capture_s"],
        device_name=device_name, traces=[r["trace"] for r in ranks if r["trace"] is not None],
        trace_iterations=spec["mix"]["trace_iterations"])


def result(spec: dict, ranks: list[dict], trace: bool, device_name: str) -> tuple[dict, list[str]]:
    """The result's line and the check's lines for standard error."""
    from portbench.check import judge
    from portbench.trace import breakdown

    ctx = context(spec, ranks, device_name)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = m["read"](ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers, limits = ranks[0]["numbers"], spec["limits"]
    correct = judge(numbers, limits)
    w = ranks[0]["window"]
    device = {"platform": "gpu", "kind": device_name, "count": ctx.chips,
              "memory_peak_bytes": max(r["peak"] for r in ranks)}
    out = {"correct": correct, "attempted": w["iterations"], "failed": w["failed"], "metrics": metrics}
    if trace:
        # each rank traces its own stretch: both are the ranks' means
        device["busy_s"] = sum(t["busy_s"] for t in ctx.traces) / len(ctx.traces)
        device["window_s"] = sum(t["stretch_s"] for t in ctx.traces) / len(ctx.traces)
    out["device"] = device
    if trace:
        out["breakdown"] = breakdown(ctx.traces[0])
    out["checks"] = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    lines = [f"check {name} {numbers.get(name)!r} limit {limit!r}" for name, limit in limits.items()]
    return out, lines
