#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Card: print ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   and turn TF32 off for matmuls and cuDNN, so fp32 means IEEE fp32.
2. Build the CUDA kernels from ``rsl_rl_tpu_torch/csrc/`` (into ``build/``).
3. Hold every kernel against its plain PyTorch version on the same inputs, at
   the main-path shape (T=24, B=1024, D=15, H=256) with S=2 and S=1, in IEEE
   fp32 and in bf16-operand mode, and at T=1.
4. The slice: train the ``recurrent_gru256`` configuration (GRU-256 actor and
   critic memories, [256, 256] MLPs, obs normalization, 4096
   ``NLinkPendulum`` envs with 5 links, T=24, 5 epochs x 4 minibatches) for 3
   iterations through ``OnPolicyRunner.learn``, with every kernel launch
   counter set to 0 just before and read just after. Then check that the
   kernel replay of a collected window reproduces the acting-time policy.
5. Time each kernel at the main-path shape beside its plain version, the
   cuDNN GRU (``torch.nn.GRU``, a yardstick the port never calls) and the
   card's lower bound for the same work; then each kernel alone at S=1.

Prints ``{"kernels": [...]}`` on the line before the last and, as the last
line, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without CUDA or when any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

from rsl_rl_tpu_torch.env import NLinkPendulum
from rsl_rl_tpu_torch.ops import gru_rnn
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from rsl_rl_tpu_torch.utils import cuda_build

SOURCE = "rsl_rl_tpu_torch/csrc/gru_x.cu"
PALLAS = "rsl_rl_tpu/ops/pallas_rnn.py"

RECURRENT_GRU256 = {
    "num_steps_per_env": 24,
    "save_interval": 50,
    "seed": 1,
    "obs_groups": {"policy": ["policy"], "critic": ["policy"]},
    "policy": {
        "class_name": "ActorCriticRecurrent",
        "rnn_type": "gru",
        "rnn_hidden_dim": 256,
        "rnn_num_layers": 1,
        "actor_hidden_dims": [256, 256],
        "critic_hidden_dims": [256, 256],
        "actor_obs_normalization": True,
        "critic_obs_normalization": True,
    },
    "algorithm": {"class_name": "PPO", "num_learning_epochs": 5, "num_mini_batches": 4},
}
NUM_ENVS, NUM_LINKS, ITERATIONS = 4096, 5, 3

# Tolerances of kernel against plain version. fp32: the two sum in another
# order (the plain version through cuBLAS); values of the forward are O(1).
# The backward sums over T*B = 24,576 rows, so its tolerances are relative to
# each tensor's max. bf16 operands: a one-ulp fp32 difference between the two
# can round an operand to the neighbouring bf16 value (2^-8 relative), and
# the recurrence carries that on, so the bound is that of bf16 rounding.
TOL = {
    False: {"fwd_rtol": 1e-4, "fwd_atol": 1e-5, "bwd_rtol": 1e-3, "bwd_atol_rel": 1e-4},
    True: {"fwd_rtol": 1e-3, "fwd_atol": 2e-3, "bwd_rtol": 1e-2, "bwd_atol_rel": 5e-3},
}

# Published dense peaks (NVIDIA data sheets): fp32 outside the tensor cores
# and memory bandwidth, by part.
PEAKS = {
    "PCIe": {"fp32_flops": 51e12, "bytes_per_s": 2.0e12},
    "NVL": {"fp32_flops": 60e12, "bytes_per_s": 3.9e12},
    "SXM": {"fp32_flops": 67e12, "bytes_per_s": 3.35e12},
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str) -> tuple[str, dict]:
    if "H100" not in name:
        fail(f"peak rates are tabulated for the H100 only, got {name!r}")
    part = "PCIe" if "PCIe" in name else "NVL" if "NVL" in name else "SXM"
    return part, PEAKS[part]


def make_inputs(S, T, B, D, H, seed):
    """Random replay inputs on the card: torch-default GRU init, normal
    inputs, 15% resets (none at t=0), a random carry and output gradient."""
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    resets = (torch.rand(T, B, generator=g) < 0.15).float()
    resets[0] = 0.0
    tensors = {
        "wx": u(S, D, 3 * H), "bx": u(S, 3 * H), "wh": u(S, H, 3 * H), "bhn": u(S, H),
        "carry0": torch.randn(S, B, H, generator=g) * 0.5,
        "xs": torch.randn(S, T, B, D, generator=g),
        "resets": resets,
        "ghs": torch.randn(S, T, B, H, generator=g),
    }
    return {k: v.cuda().contiguous() for k, v in tensors.items()}


def compare(got, want, rtol, atol, relative_atol):
    """``(max abs error, max |want|, within |err| <= rtol*|want| + atol)``,
    with ``atol`` scaled by ``max |want|`` when ``relative_atol``."""
    err = (got - want).abs()
    scale = float(want.abs().max())
    bound = atol * (scale if relative_atol else 1.0)
    ok = bool(torch.all(err <= rtol * want.abs() + bound)) and bool(torch.isfinite(got).all())
    return float(err.max()), scale, ok


def check_kernels(S, T, B, D, H, bf16, seed):
    """One case: each kernel against its plain version on the same inputs."""
    x = make_inputs(S, T, B, D, H, seed)
    tol = TOL[bf16]
    w = (x["wx"], x["bx"], x["wh"], x["bhn"], x["carry0"], x["xs"], x["resets"])
    result = {}

    hs = gru_rnn.gru_x_fwd(*w, bf16)
    hs_plain = gru_rnn.gru_x_plain_fwd(*w, bf16)
    result["gru_x_fwd"] = [compare(hs, hs_plain, tol["fwd_rtol"], tol["fwd_atol"], False)]

    # the backward and the reduction both take the plain version's upstream
    # outputs, so each kernel is held against its plain version alone
    dx, dc0, gs = gru_rnn.gru_x_bwd(*w, hs_plain, x["ghs"], bf16)
    want = gru_rnn.gru_x_plain_bwd(*w, hs_plain, x["ghs"], bf16)
    result["gru_x_bwd"] = [
        compare(a, b, tol["bwd_rtol"], tol["bwd_atol_rel"], True) for a, b in zip((dx, dc0, gs), want)
    ]
    gs_plain = want[2]
    got = gru_rnn.gru_x_wgrad(x["xs"], x["resets"], x["carry0"], hs_plain, gs_plain, bf16)
    want = gru_rnn.gru_x_plain_wgrad(x["xs"], x["resets"], x["carry0"], hs_plain, gs_plain, bf16)
    result["gru_x_wgrad"] = [
        compare(a, b, tol["bwd_rtol"], tol["bwd_atol_rel"], True) for a, b in zip(got, want)
    ]
    torch.cuda.synchronize()
    return result


def kernel_calls(x):
    """``{kernel: (kernel call, plain-version call)}`` on the inputs ``x``."""
    w = (x["wx"], x["bx"], x["wh"], x["bhn"], x["carry0"], x["xs"], x["resets"])
    hs = gru_rnn.gru_x_fwd(*w)
    _, _, gs = gru_rnn.gru_x_bwd(*w, hs, x["ghs"])
    rows = (x["xs"], x["resets"], x["carry0"], hs, gs)
    return {
        "gru_x_fwd": (lambda: gru_rnn.gru_x_fwd(*w), lambda: gru_rnn.gru_x_plain_fwd(*w)),
        "gru_x_bwd": (lambda: gru_rnn.gru_x_bwd(*w, hs, x["ghs"]),
                      lambda: gru_rnn.gru_x_plain_bwd(*w, hs, x["ghs"])),
        "gru_x_wgrad": (lambda: gru_rnn.gru_x_wgrad(*rows), lambda: gru_rnn.gru_x_plain_wgrad(*rows)),
    }


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def work(S, T, B, D, H):
    """Operations and bytes each kernel's function needs (fp32, 4 B a value):
    every input read once, every output written once."""
    f = 4
    rows = T * B
    weights = S * (D * 3 * H + 3 * H + H * 3 * H + H)
    fwd_ops = S * 2 * rows * (H + D) * 3 * H
    return {
        "gru_x_fwd": (
            fwd_ops,
            f * (S * rows * D + rows + S * B * H + weights + S * rows * H),
        ),
        # recompute of the forward products, dgates @ Whᵀ, dxproj @ Wxᵀ
        "gru_x_bwd": (
            fwd_ops + S * 2 * rows * 3 * H * (H + D),
            f * (S * rows * D + rows + S * B * H + weights + 2 * S * rows * H
                 + S * rows * D + S * B * H + S * rows * 4 * H),
        ),
        # dWh, dWx products and the bias sums
        "gru_x_wgrad": (
            S * (2 * rows * (H + D) * 3 * H + rows * 4 * H),
            f * (S * rows * D + rows + S * B * H + S * rows * H + S * rows * 4 * H
                 + S * (H + D + 1) * 4 * H),
        ),
    }


def library_gru_ms(S, T, B, D, H, x, reps):
    """cuDNN GRU (``torch.nn.GRU``) on the same shapes with no resets: the
    same function when no carry is reset. Forward ms, backward ms (data and
    weight gradients together) for S streams, and its forward output of
    stream 0 for an agreement check."""
    grus, grads_in = [], []
    for s in range(S):
        gru = torch.nn.GRU(D, H).cuda()
        with torch.no_grad():
            gru.weight_ih_l0.copy_(x["wx"][s].T)
            gru.weight_hh_l0.copy_(x["wh"][s].T)
            gru.bias_ih_l0.copy_(x["bx"][s])
            gru.bias_hh_l0.copy_(torch.cat([torch.zeros(2 * H, device="cuda"), x["bhn"][s]]))
        grus.append(gru)
    xs = [x["xs"][s].clone().requires_grad_(True) for s in range(S)]
    h0 = [x["carry0"][s][None].clone().requires_grad_(True) for s in range(S)]

    def fwd():
        return [grus[s](xs[s], h0[s])[0] for s in range(S)]

    fwd_ms = time_ms(fwd, reps)
    outs = fwd()
    for s in range(S):
        grads_in.append([xs[s], h0[s], *grus[s].parameters()])

    def bwd():
        for s in range(S):
            torch.autograd.grad(outs[s], grads_in[s], x["ghs"][s], retain_graph=True)

    bwd_ms = time_ms(bwd, reps)
    return fwd_ms, bwd_ms, outs[0].detach()


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"TF32 off: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    kind = torch.cuda.get_device_name(0)
    part, peaks = card_peaks(kind)
    print(f"device: {kind} ({part} peaks: {peaks['fp32_flops'] / 1e12:.0f} TFLOP/s fp32,"
          f" {peaks['bytes_per_s'] / 1e12:.2f} TB/s); torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    start = time.perf_counter()
    cuda_build.build_all()
    print(f"build: {time.perf_counter() - start:.1f} s")
    for name, log in cuda_build.BUILD_LOG.items():
        lines = [ln.strip() for ln in log["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: nvcc {log['seconds']:.1f} s; ptxas: " + " | ".join(lines))

    # ---- 3. kernels against their plain versions
    T = RECURRENT_GRU256["num_steps_per_env"]
    B = NUM_ENVS // RECURRENT_GRU256["algorithm"]["num_mini_batches"]
    D = 3 * NUM_LINKS
    H = RECURRENT_GRU256["policy"]["rnn_hidden_dim"]
    max_abs = {}
    passed = {k: True for k in ("gru_x_fwd", "gru_x_bwd", "gru_x_wgrad")}
    cases = [(2, T, bf16) for bf16 in (False, True)] + [(1, T, bf16) for bf16 in (False, True)]
    cases += [(2, 1, False), (2, 1, True)]
    for i, (S, t, bf16) in enumerate(cases):
        res = check_kernels(S, t, B, D, H, bf16, seed=100 + i)
        summary = []
        for name, checks in res.items():
            err = max(e for e, _, _ in checks)
            scale = max(m for _, m, _ in checks)
            ok = all(o for _, _, o in checks)
            passed[name] &= ok
            if (S, t, bf16) == (2, T, False):
                max_abs[name] = err
            summary.append(f"{name} max_abs_err={err:.3e} (max |plain| {scale:.3g})"
                           f" {'ok' if ok else 'FAIL'}")
        tol = TOL[bf16]
        print(f"check S={S} T={t} B={B} D={D} H={H} {'bf16' if bf16 else 'fp32'}"
              f" (fwd rtol {tol['fwd_rtol']:g} atol {tol['fwd_atol']:g}; bwd rtol {tol['bwd_rtol']:g}"
              f" atol {tol['bwd_atol_rel']:g} x max |plain|): " + "; ".join(summary))
    if not all(passed.values()):
        fail(f"kernel disagrees with its plain version: {passed}")

    # ---- 4. the slice
    env = NLinkPendulum(NUM_ENVS, NUM_LINKS, device="cuda")
    runner = OnPolicyRunner(env, RECURRENT_GRU256, device="cuda")
    gru_rnn.launch_counts.reset()
    runner.learn(ITERATIONS)
    torch.cuda.synchronize()
    launches = {
        "gru_x_fwd": gru_rnn.launch_counts.fwd_launches,
        "gru_x_bwd": gru_rnn.launch_counts.bwd_launches,
        "gru_x_wgrad": gru_rnn.launch_counts.wgrad_launches,
    }
    alg_cfg = RECURRENT_GRU256["algorithm"]
    expected = ITERATIONS * alg_cfg["num_learning_epochs"] * alg_cfg["num_mini_batches"]
    print(f"slice launches: {launches} (expected {expected} each)")
    if any(n != expected for n in launches.values()):
        fail(f"main path launches {launches}, expected {expected} of each kernel")
    for row in runner.history:
        bad = {k: v for k, v in row["metrics"].items() if not math.isfinite(v)}
        if bad:
            fail(f"non-finite metrics in iteration {row['iteration']}: {bad}")
        print(f"iteration {row['iteration']}: collection {row['collection_s']:.4f} s,"
              f" learning {row['learn_s']:.4f} s, {row['steps_per_s']:.0f} env-steps/s,"
              f" losses " + ", ".join(f"{k}={v:.4g}" for k, v in row["metrics"].items()
                                      if k.startswith("Loss/")))
    print("slice: " + json.dumps({"iterations": [
        {k: row[k] for k in ("iteration", "collection_s", "learn_s", "steps_per_s")}
        for row in runner.history]}))

    # the kernel replay of a fresh window reproduces the acting-time outputs
    # (the PPO invariant: replayed log-probs equal behavior log-probs). The
    # normalizers are frozen for this window, since the update replays with
    # the moments as they stand after the collection.
    policy = runner.alg.policy
    for norm in (policy.norm_actor, policy.norm_critic):
        norm.until = float(norm.count)
    _, rollout, _ = runner.alg.collect(env, runner.collect_state, T)
    with torch.no_grad():
        sl = slice(0, B)
        carry0 = {k: tuple(h[sl] for h in v) for k, v in rollout.carry0.items()}
        obs = {k: v[:, sl] for k, v in rollout.obs.items()}
        mean, _, value = policy.act_value_seq(obs, carry0, rollout.replay_resets()[:, sl])
    err_mu = float((mean - rollout.mu[:, sl]).abs().max())
    err_v = float((value - rollout.values[:, sl]).abs().max())
    print(f"replay vs acting over a collected window: mean max_abs_err={err_mu:.3e},"
          f" value max_abs_err={err_v:.3e}")
    if not (err_mu < 1e-4 and err_v < 1e-3 * max(1.0, float(rollout.values.abs().max()))):
        fail("kernel replay does not reproduce the acting-time outputs")

    # ---- 5. times at the main-path shape
    S = 2
    x = make_inputs(S, T, B, D, H, seed=7)
    w = (x["wx"], x["bx"], x["wh"], x["bhn"], x["carry0"], x["xs"], x["resets"])
    times = {name: (time_ms(kernel, 20), time_ms(plain, 5))
             for name, (kernel, plain) in kernel_calls(x).items()}
    lib_fwd, lib_bwd, lib_out = library_gru_ms(S, T, B, D, H, x, 20)
    # with no resets the kernel computes cuDNN's function: check agreement
    hs0 = gru_rnn.gru_x_fwd(*w[:6], torch.zeros_like(x["resets"]))
    lib_err = float((hs0[0] - lib_out).abs().max())
    print(f"cuDNN GRU vs gru_x_fwd without resets: max_abs_err={lib_err:.3e}")
    if not lib_err < 1e-4:
        fail("gru_x_fwd disagrees with cuDNN's GRU where both compute the same function")
    library = {"gru_x_fwd": lib_fwd, "gru_x_bwd": lib_bwd, "gru_x_wgrad": None}

    replaces = {
        "gru_x_fwd": (f"{PALLAS}:1354", [f"{PALLAS}:492"]),
        "gru_x_bwd": (f"{PALLAS}:1414", [f"{PALLAS}:548"]),
        "gru_x_wgrad": (f"{PALLAS}:1485", [f"{PALLAS}:619"]),
    }
    kernels = []
    for name, (ops, nbytes) in work(S, T, B, D, H).items():
        t_ops = ops / peaks["fp32_flops"] * 1e3
        t_bytes = nbytes / peaks["bytes_per_s"] * 1e3
        ms, plain_ms = times[name]
        print(f"time {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library"
              f" {library[name] if library[name] is None else f'{library[name]:.4f}'} ms);"
              f" bound max({ops / 1e9:.2f} GFLOP / {peaks['fp32_flops'] / 1e12:.0f} TFLOP/s ="
              f" {t_ops:.4f} ms, {nbytes / 1e6:.1f} MB / {peaks['bytes_per_s'] / 1e12:.2f} TB/s ="
              f" {t_bytes:.4f} ms)")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces[name][0],
            "also_replaces": replaces[name][1],
            "launches": launches[name],
            "max_abs_err": max_abs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[name],
            "passed": passed[name],
        })
    # the same kernels at S=1, the work of the single-stream Pallas kernels
    x1 = make_inputs(1, T, B, D, H, seed=8)
    calls = kernel_calls(x1)
    lib1 = dict(zip(("gru_x_fwd", "gru_x_bwd"), library_gru_ms(1, T, B, D, H, x1, 20)[:2]))
    for name, (ops, nbytes) in work(1, T, B, D, H).items():
        bound = max(ops / peaks["fp32_flops"], nbytes / peaks["bytes_per_s"]) * 1e3
        kernel, plain = calls[name]
        print(f"time {name} at S=1: {time_ms(kernel, 20):.4f} ms (plain {time_ms(plain, 5):.4f} ms,"
              f" library {lib1.get(name)} ms, bound {bound:.4f} ms)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
