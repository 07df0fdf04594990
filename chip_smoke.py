#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Card: print ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   and turn TF32 off for matmuls and cuDNN, so fp32 means IEEE fp32.
2. Build the CUDA kernels from ``rsl_rl_tpu_torch/csrc/`` (into ``build/``,
   one ``nvcc`` per source, all in parallel).
3. Hold every kernel (GRU and LSTM) against its plain PyTorch version on the
   same inputs, at the main-path shape (T=24, B=1024, D=15, H=256) with S=2
   and S=1, in IEEE fp32 and in bf16-operand mode, and at T=1.
4. The slices, each through ``OnPolicyRunner.learn`` for 3 iterations with
   every kernel launch counter set to 0 just before and read just after:
   ``recurrent_gru256`` (GRU-256 actor and critic memories, [256, 256] MLPs,
   obs normalization, fp32) and ``recurrent_lstm256_bf16`` (the same with
   LSTM-256 memories and ``dtype=bfloat16``: bf16 MLP trunks with fp32
   heads, bf16 memory matmul operands), both on 4096 ``NLinkPendulum`` envs
   with 5 links, T=24, 5 epochs x 4 minibatches. After each, check that the
   kernel replay of a collected window reproduces the acting-time policy.
5. Time each kernel at the main-path shape beside its plain version, a
   PyTorch yardstick the port never calls (cuDNN's ``torch.nn.GRU`` /
   ``torch.nn.LSTM``; one ``torch.bmm`` for the weight-gradient reductions)
   and the card's lower bound for the same work; then each kernel at S=1.

Prints ``{"kernels": [...]}`` on the line before the last and, as the last
line, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without CUDA or when any phase fails.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import torch

from rsl_rl_tpu_torch.env import NLinkPendulum
from rsl_rl_tpu_torch.networks.memory import memory_sequence, paired_sequence
from rsl_rl_tpu_torch.ops import gru_rnn, lstm_rnn
from rsl_rl_tpu_torch.runners import OnPolicyRunner
from rsl_rl_tpu_torch.storage.rollout import slice_envs
from rsl_rl_tpu_torch.utils import cuda_build

PALLAS = "rsl_rl_tpu/ops/pallas_rnn.py"
FAMILIES = {
    "gru": {"module": gru_rnn, "source": "rsl_rl_tpu_torch/csrc/gru_x.cu", "gates": 3,
            "kernels": ("gru_x_fwd", "gru_x_bwd", "gru_x_wgrad")},
    "lstm": {"module": lstm_rnn, "source": "rsl_rl_tpu_torch/csrc/lstm_x.cu", "gates": 4,
             "kernels": ("lstm_x_fwd", "lstm_x_bwd", "lstm_x_wgrad")},
}
#: the TPU kernel each replaces (stream-paired) and the single-stream ones
REPLACES = {
    "gru_x_fwd": (f"{PALLAS}:1354", [f"{PALLAS}:492"]),
    "gru_x_bwd": (f"{PALLAS}:1414", [f"{PALLAS}:548"]),
    "gru_x_wgrad": (f"{PALLAS}:1485", [f"{PALLAS}:619"]),
    "lstm_x_fwd": (f"{PALLAS}:1619", [f"{PALLAS}:1051"]),
    "lstm_x_bwd": (f"{PALLAS}:1690", [f"{PALLAS}:1122"]),
    "lstm_x_wgrad": (f"{PALLAS}:1764", [f"{PALLAS}:1195"]),
}

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
# bench.py's recurrent_lstm256_bf16: the same _build with rnn_type="lstm" and
# dtype=bfloat16
RECURRENT_LSTM256_BF16 = copy.deepcopy(RECURRENT_GRU256)
RECURRENT_LSTM256_BF16["policy"].update(rnn_type="lstm", dtype=torch.bfloat16)
SLICES = {"recurrent_gru256": ("gru", RECURRENT_GRU256),
          "recurrent_lstm256_bf16": ("lstm", RECURRENT_LSTM256_BF16)}
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
# Replay against acting. The memory outputs hold the bars of the JAX
# package's same-scheme test (tests/test_pallas_rnn.py:153-175): fp32
# differences of summation order, and in bf16 mode the operand roundings they
# flip. The policy mean and value: in fp32 summation-order bars; in bf16 the MLP
# trunks go through cuBLAS bf16 GEMMs at other shapes when acting ([4096,256])
# and replaying ([24*1024,256]), which may sum in another order (split-K with
# bf16 reductions is allowed by default) and round each layer's output to
# bf16 on its own, so a trunk activation may differ by a few bf16 ulps
# (2^-8 relative each): the bound is 8 ulps of bf16 at the output's scale.
MEMORY_TOL = {"rtol": 1e-3, "atol": 5e-4}
# (mean atol, relative to max(1, max |mean|)?, value atol relative to max(1, max |value|))
POLICY_TOL = {False: (1e-4, False, 1e-3), True: (2.0**-5, True, 2.0**-5)}

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


def make_inputs(family, S, T, B, D, H, seed):
    """Random replay inputs on the card: torch-default RNN init, normal
    inputs, 15% resets (none at t=0), a random carry and output gradient.
    ``x["w"]`` holds the positional inputs of the family's kernels."""
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    resets = (torch.rand(T, B, generator=g) < 0.15).float()
    resets[0] = 0.0
    if family == "gru":
        names = ("wx", "bx", "wh", "bhn", "carry0", "xs", "resets")
        tensors = {
            "wx": u(S, D, 3 * H), "bx": u(S, 3 * H), "wh": u(S, H, 3 * H), "bhn": u(S, H),
            "carry0": torch.randn(S, B, H, generator=g) * 0.5,
        }
    else:
        names = ("wx", "wh", "bh", "c0", "h0", "xs", "resets")
        tensors = {
            "wx": u(S, D, 4 * H), "wh": u(S, H, 4 * H), "bh": u(S, 4 * H),
            "c0": torch.randn(S, B, H, generator=g), "h0": torch.randn(S, B, H, generator=g) * 0.5,
        }
    tensors.update(xs=torch.randn(S, T, B, D, generator=g), resets=resets,
                   ghs=torch.randn(S, T, B, H, generator=g))
    x = {k: v.cuda().contiguous() for k, v in tensors.items()}
    x["w"] = tuple(x[k] for k in names)
    if family == "gru":
        x["h0"] = x["carry0"]  # the hidden state entering step 0, as for the LSTM
    return x


def compare(got, want, rtol, atol, relative_atol):
    """``(max abs error, max |want|, within |err| <= rtol*|want| + atol)``,
    with ``atol`` scaled by ``max |want|`` when ``relative_atol``."""
    err = (got - want).abs()
    scale = float(want.abs().max())
    bound = atol * (scale if relative_atol else 1.0)
    ok = bool(torch.all(err <= rtol * want.abs() + bound)) and bool(torch.isfinite(got).all())
    return float(err.max()), scale, ok


def forward_state(family, hs_cs):
    """The forward outputs the backward takes: ``(hs,)`` or ``(hs, cs)``."""
    return (hs_cs,) if family == "gru" else hs_cs


def check_kernels(family, S, T, B, D, H, bf16, seed):
    """One case: each kernel of the family against its plain version on the
    same inputs. The backward and the reduction both take the plain
    version's upstream outputs, so each kernel is held against its plain
    version alone."""
    mod = FAMILIES[family]["module"]
    fwd, bwd, wgrad = FAMILIES[family]["kernels"]
    x = make_inputs(family, S, T, B, D, H, seed)
    tol = TOL[bf16]
    w = x["w"]
    result = {}

    got = getattr(mod, fwd)(*w, bf16)
    want = getattr(mod, fwd.replace("_x_", "_x_plain_"))(*w, bf16)
    result[fwd] = [compare(a, b, tol["fwd_rtol"], tol["fwd_atol"], False)
                   for a, b in zip(forward_state(family, got), forward_state(family, want))]
    state = forward_state(family, want)
    got = getattr(mod, bwd)(*w, *state, x["ghs"], bf16)
    want = getattr(mod, bwd.replace("_x_", "_x_plain_"))(*w, *state, x["ghs"], bf16)
    result[bwd] = [compare(a, b, tol["bwd_rtol"], tol["bwd_atol_rel"], True) for a, b in zip(got, want)]
    rows = (x["xs"], x["resets"], x["h0"], state[0], want[-1])
    got = getattr(mod, wgrad)(*rows, bf16)
    want = getattr(mod, wgrad.replace("_x_", "_x_plain_"))(*rows, bf16)
    result[wgrad] = [compare(a, b, tol["bwd_rtol"], tol["bwd_atol_rel"], True) for a, b in zip(got, want)]
    torch.cuda.synchronize()
    return result


def kernel_calls(family, x):
    """``{kernel: (kernel call, plain-version call)}`` on the inputs ``x``,
    and ``(h_prev rows' inputs, gscratch)`` for the library reduction."""
    mod = FAMILIES[family]["module"]
    fwd, bwd, wgrad = FAMILIES[family]["kernels"]
    w = x["w"]
    state = forward_state(family, getattr(mod, fwd)(*w))
    gs = getattr(mod, bwd)(*w, *state, x["ghs"])[-1]
    rows = (x["xs"], x["resets"], x["h0"], state[0], gs)

    def plain(name):
        return getattr(mod, name.replace("_x_", "_x_plain_"))

    calls = {
        fwd: (lambda: getattr(mod, fwd)(*w), lambda: plain(fwd)(*w)),
        bwd: (lambda: getattr(mod, bwd)(*w, *state, x["ghs"]), lambda: plain(bwd)(*w, *state, x["ghs"])),
        wgrad: (lambda: getattr(mod, wgrad)(*rows), lambda: plain(wgrad)(*rows)),
    }
    return calls, rows


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


def work(family, S, T, B, D, H):
    """Operations and bytes each kernel's function needs (fp32, 4 B a value):
    every input read once, every output written once."""
    f = 4
    rows = T * B
    G = FAMILIES[family]["gates"]
    fwd, bwd, wgrad = FAMILIES[family]["kernels"]
    if family == "gru":
        weights = S * (D * 3 * H + 3 * H + H * 3 * H + H)
        carries = S * B * H  # carry0 in, dcarry0 out
        states = S * rows * H  # hs
    else:
        weights = S * (D * 4 * H + H * 4 * H + 4 * H)
        carries = 2 * S * B * H  # (c0, h0) in, (dc0, dh0) out
        states = 2 * S * rows * H  # hs, cs
    fwd_ops = S * 2 * rows * (H + D) * G * H
    return {
        fwd: (fwd_ops, f * (S * rows * D + rows + carries + weights + states)),
        # recompute of the forward products, dgates @ Whᵀ, dgates @ Wxᵀ
        bwd: (
            fwd_ops + S * 2 * rows * G * H * (H + D),
            f * (S * rows * D + rows + carries + weights + states + S * rows * H
                 + S * rows * D + carries + S * rows * 4 * H),
        ),
        # dWh, dWx products and the bias sums
        wgrad: (
            S * (2 * rows * (H + D) * G * H + rows * 4 * H),
            f * (S * rows * D + rows + S * B * H + S * rows * H + S * rows * 4 * H
                 + S * (H + D + 1) * 4 * H),
        ),
    }


def library_rnn_ms(family, S, T, B, D, H, x, reps):
    """cuDNN's ``torch.nn.GRU`` / ``torch.nn.LSTM`` on the same shapes with no
    resets: the same function when no carry is reset. Forward ms, backward
    ms (data and weight gradients together) for S streams, and its forward
    output of stream 0 for an agreement check."""
    nets, grads_in = [], []
    for s in range(S):
        if family == "gru":
            net = torch.nn.GRU(D, H).cuda()
            with torch.no_grad():
                net.weight_ih_l0.copy_(x["wx"][s].T)
                net.weight_hh_l0.copy_(x["wh"][s].T)
                net.bias_ih_l0.copy_(x["bx"][s])
                net.bias_hh_l0.copy_(torch.cat([torch.zeros(2 * H, device="cuda"), x["bhn"][s]]))
        else:
            net = torch.nn.LSTM(D, H).cuda()
            with torch.no_grad():
                net.weight_ih_l0.copy_(x["wx"][s].T)
                net.weight_hh_l0.copy_(x["wh"][s].T)
                net.bias_ih_l0.zero_()
                net.bias_hh_l0.copy_(x["bh"][s])
        nets.append(net)
    xs = [x["xs"][s].clone().requires_grad_(True) for s in range(S)]
    if family == "gru":
        carry = [x["carry0"][s][None].clone().requires_grad_(True) for s in range(S)]
        leaves = [[c] for c in carry]
    else:
        carry = [(x["h0"][s][None].clone().requires_grad_(True), x["c0"][s][None].clone().requires_grad_(True))
                 for s in range(S)]
        leaves = [list(c) for c in carry]

    def fwd():
        return [nets[s](xs[s], carry[s])[0] for s in range(S)]

    fwd_ms = time_ms(fwd, reps)
    outs = fwd()
    for s in range(S):
        grads_in.append([xs[s], *leaves[s], *nets[s].parameters()])

    def bwd():
        for s in range(S):
            torch.autograd.grad(outs[s], grads_in[s], x["ghs"][s], retain_graph=True)

    bwd_ms = time_ms(bwd, reps)
    return fwd_ms, bwd_ms, outs[0].detach()


def library_wgrad_ms(rows, reps):
    """One ``torch.bmm`` of the prepared ``[h_masked | x | 1]ᵀ [S, H+D+1, T*B]``
    by the gate-gradient scratch ``[S, T*B, 4H]``: the function of the
    weight-gradient reduction (in fp32; the bf16 mode has no library call)."""
    xs, resets, h0, hs, gs = rows
    S, T, B, D = xs.shape
    H = h0.shape[-1]
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1) * (1.0 - resets)[None, :, :, None]
    A = torch.cat([h_prev, xs, torch.ones(S, T, B, 1, device=xs.device)], dim=-1).reshape(S, T * B, -1)
    At, G = A.transpose(1, 2), gs.reshape(S, T * B, 4 * H)
    return time_ms(lambda: torch.bmm(At, G), reps)


def all_counts() -> dict:
    return {
        name: getattr(fam["module"].launch_counts, f"{name.split('_')[-1]}_launches")
        for fam in FAMILIES.values() for name in fam["kernels"]
    }


def reset_counts() -> None:
    for fam in FAMILIES.values():
        fam["module"].launch_counts.reset()


def run_slice(name, family, cfg, T, B):
    """Train ``cfg`` for ITERATIONS through ``OnPolicyRunner.learn`` with the
    launch counters zeroed just before and read just after; then hold the
    kernel replay of a collected window against the acting-time outputs.
    Returns the launches of the family's kernels."""
    env = NLinkPendulum(NUM_ENVS, NUM_LINKS, device="cuda")
    runner = OnPolicyRunner(env, cfg, device="cuda")
    reset_counts()
    runner.learn(ITERATIONS)
    torch.cuda.synchronize()
    counts = all_counts()
    alg_cfg = cfg["algorithm"]
    expected = ITERATIONS * alg_cfg["num_learning_epochs"] * alg_cfg["num_mini_batches"]
    want = {k: expected if k in FAMILIES[family]["kernels"] else 0 for k in counts}
    print(f"{name} launches: {counts} (expected {expected} of each {family} kernel, 0 of the others)")
    if counts != want:
        fail(f"{name}: main path launches {counts}, expected {want}")
    for row in runner.history:
        bad = {k: v for k, v in row["metrics"].items() if not math.isfinite(v)}
        if bad:
            fail(f"{name}: non-finite metrics in iteration {row['iteration']}: {bad}")
        print(f"{name} iteration {row['iteration']}: collection {row['collection_s']:.4f} s,"
              f" learning {row['learn_s']:.4f} s, {row['steps_per_s']:.0f} env-steps/s,"
              f" losses " + ", ".join(f"{k}={v:.4g}" for k, v in row["metrics"].items()
                                      if k.startswith("Loss/")))
    print(f"{name}: " + json.dumps({"iterations": [
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
    bf16 = policy.dtype is not None
    with torch.no_grad():
        carry0 = slice_envs(rollout.carry0, 0, B, axis=0)
        obs = {k: v[:, :B] for k, v in rollout.obs.items()}
        resets = rollout.replay_resets()[:, :B]
        mean, _, value = policy.act_value_seq(obs, carry0, resets)
        xa, xc = policy._actor_in(obs), policy._critic_in(obs)
        fa, fc = paired_sequence(policy.memory_a, carry0["actor"], xa, policy.memory_c, carry0["critic"], xc,
                                 resets)
        mem_ok = True
        for role, got, mem, x in (("actor", fa, policy.memory_a, xa), ("critic", fc, policy.memory_c, xc)):
            want = memory_sequence(mem, carry0[role], x, resets)
            err, scale, ok = compare(got, want, MEMORY_TOL["rtol"], MEMORY_TOL["atol"], False)
            mem_ok &= ok
            print(f"{name} replay vs acting, {role} memory outputs: max_abs_err={err:.3e}"
                  f" (max |acting| {scale:.3g}; rtol {MEMORY_TOL['rtol']:g} atol {MEMORY_TOL['atol']:g})"
                  f" {'ok' if ok else 'FAIL'}")
    mu_tol, mu_relative, v_tol = POLICY_TOL[bf16]
    err_mu = float((mean - rollout.mu[:, :B]).abs().max())
    err_v = float((value - rollout.values[:, :B]).abs().max())
    mu_bound = mu_tol * (max(1.0, float(rollout.mu.abs().max())) if mu_relative else 1.0)
    v_bound = v_tol * max(1.0, float(rollout.values.abs().max()))
    print(f"{name} replay vs acting over a collected window: mean max_abs_err={err_mu:.3e}"
          f" (bound {mu_bound:.3e}), value max_abs_err={err_v:.3e} (bound {v_bound:.3e})")
    if not (mem_ok and err_mu < mu_bound and err_v < v_bound):
        fail(f"{name}: kernel replay does not reproduce the acting-time outputs")
    return {k: counts[k] for k in FAMILIES[family]["kernels"]}


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
    passed = {}
    cases = [(2, T, bf16) for bf16 in (False, True)] + [(1, T, bf16) for bf16 in (False, True)]
    cases += [(2, 1, False), (2, 1, True)]
    for offset, family in ((100, "gru"), (200, "lstm")):
        for i, (S, t, bf16) in enumerate(cases):
            res = check_kernels(family, S, t, B, D, H, bf16, seed=offset + i)
            summary = []
            for name, checks in res.items():
                err = max(e for e, _, _ in checks)
                scale = max(m for _, m, _ in checks)
                ok = all(o for _, _, o in checks)
                passed[name] = passed.get(name, True) and ok
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

    # ---- 4. the slices
    launches = {}
    for name, (family, cfg) in SLICES.items():
        launches.update(run_slice(name, family, cfg, T, B))

    # ---- 5. times at the main-path shape
    kernels = []
    for seed, family in ((7, "gru"), (9, "lstm")):
        S = 2
        x = make_inputs(family, S, T, B, D, H, seed=seed)
        calls, rows = kernel_calls(family, x)
        times = {name: (time_ms(kernel, 20), time_ms(plain, 5)) for name, (kernel, plain) in calls.items()}
        lib_fwd, lib_bwd, lib_out = library_rnn_ms(family, S, T, B, D, H, x, 20)
        fwd, bwd, wgrad = FAMILIES[family]["kernels"]
        # with no resets the kernel computes cuDNN's function: check agreement
        hs0 = getattr(FAMILIES[family]["module"], fwd)(*x["w"][:6], torch.zeros_like(x["resets"]))
        hs0 = hs0 if family == "gru" else hs0[0]
        lib_err = float((hs0[0] - lib_out).abs().max())
        print(f"cuDNN {family.upper()} vs {fwd} without resets: max_abs_err={lib_err:.3e}")
        if not lib_err < 1e-4:
            fail(f"{fwd} disagrees with cuDNN's {family.upper()} where both compute the same function")
        library = {fwd: lib_fwd, bwd: lib_bwd, wgrad: library_wgrad_ms(rows, 20)}

        for name, (ops, nbytes) in work(family, S, T, B, D, H).items():
            t_ops = ops / peaks["fp32_flops"] * 1e3
            t_bytes = nbytes / peaks["bytes_per_s"] * 1e3
            ms, plain_ms = times[name]
            print(f"time {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library {library[name]:.4f} ms);"
                  f" bound max({ops / 1e9:.2f} GFLOP / {peaks['fp32_flops'] / 1e12:.0f} TFLOP/s ="
                  f" {t_ops:.4f} ms, {nbytes / 1e6:.1f} MB / {peaks['bytes_per_s'] / 1e12:.2f} TB/s ="
                  f" {t_bytes:.4f} ms)")
            kernels.append({
                "name": name,
                "route": "cuda",
                "source": FAMILIES[family]["source"],
                "replaces": REPLACES[name][0],
                "also_replaces": REPLACES[name][1],
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
        x1 = make_inputs(family, 1, T, B, D, H, seed=seed + 1)
        calls, rows = kernel_calls(family, x1)
        lib1 = dict(zip((fwd, bwd), library_rnn_ms(family, 1, T, B, D, H, x1, 20)[:2]))
        lib1[wgrad] = library_wgrad_ms(rows, 20)
        for name, (ops, nbytes) in work(family, 1, T, B, D, H).items():
            bound = max(ops / peaks["fp32_flops"], nbytes / peaks["bytes_per_s"]) * 1e3
            kernel, plain = calls[name]
            print(f"time {name} at S=1: {time_ms(kernel, 20):.4f} ms (plain {time_ms(plain, 5):.4f} ms,"
                  f" library {lib1[name]:.4f} ms, bound {bound:.4f} ms)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
