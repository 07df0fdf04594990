#!/usr/bin/env python3
"""Time the port's kernels from two source trees on one card, in turns.

    python3 kernel_ab.py BASE_ROOT [--reps 20] [--family gru_xp lstm_xp]
    python3 kernel_ab.py --variant stream-rest all-streamed [--family ...]
    python3 kernel_ab.py --variant fp32-cluster --shapes gru_xp:8:512 ...

``BASE_ROOT`` is the root of another checkout of the repository (for example
the parent commit unpacked with ``git archive`` into ``build/base``). With
``--variant NAME ...`` each base is instead a copy of this tree's sources under
``build/variant/NAME/`` with the edits of ``VARIANTS[NAME]`` applied: a design
the sources do not ship, timed against the one they do. Their
``rsl_rl_tpu_torch/csrc/*.cu`` build with the flags of
``rsl_rl_tpu_torch/utils/cuda_build.py`` into ``build/ab/<base>/``, one
``nvcc`` per source and base, all at once; this tree's own kernels build as
usual. Every kernel entry point then runs at its main-path shape
(``chip_smoke.py``'s inputs: the x kernels at T=24, B=1024, D=15, H=256, S=2
and S=1; the xproj kernels at G=16, B=128, and at G=1, B=1024, the
wide-input path's shape; ``--shapes``: these shapes instead, ``--family``:
those families' shapes alone) in fp32 and in bf16-operand mode, timed with
CUDA events in the order base, this, this, base for each base, so that a
drift of the card during the run shows. One line a kernel, shape, mode and
base, with the four times and the ratio of this tree's mean to the base's
(the base named ``base`` or by its variant); the card's name and power limit
first. Both trees'
libraries go through this tree's wrappers, so the C interfaces must agree
(an argument the base does not take is ignored by its function).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from rsl_rl_tpu_torch.ops.rnn_common import raise_on
from rsl_rl_tpu_torch.utils import cuda_build

#: the sources' choice of the xproj forwards' fp32 kernel by the step costs
#: of the two (xp_fwd_columns)
_RULE = "*columns = !p.resident || p.waves * step > cols;"
_FP32_CLUSTER = [("rnn_fwd.cuh", _RULE, "*columns = false;\n  (void)step;\n  (void)cols;")]
#: kStreamRest, a layout for the streams past those a cluster holds whole:
#: their weight slices stream from L2 through a ring sized for streamed stages
#: (a.held: the parts whose slices a CTA holds), chosen where two slices do
#: not fit a CTA but one does
_STREAM_REST = [
    ("rnn_fwd.cuh", "  const float* xproj;  // the stored input projection\n",
     "  const float* xproj;  // the stored input projection\n  int held;\n"),
    ("rnn_fwd.cuh", "template <class Cell, bool BF16, bool kResident, int kTail>\n__global__ void __launch_bounds__(256, 1) rnn_xp",
     "template <class Cell, bool BF16, bool kResident, int kTail, bool kStreamRest>\n"
     "__global__ void __launch_bounds__(256, 1) rnn_xp"),
    ("rnn_fwd.cuh", "  float* bias_s = fwd_smem + a.parts * slice;\n",
     "  float* bias_s = fwd_smem + (kStreamRest ? a.held : a.parts) * slice;\n"),
    ("rnn_fwd.cuh", "  for (int p = 0; p < n_parts; ++p)\n    fwd_stage_slice<Cell, BF16, kResident>"
     "(a, part(p), fwd_smem + p * slice, bias_s + p * bias_n);\n",
     "  for (int p = 0; p < n_parts; ++p) {\n    if constexpr (kStreamRest) {\n      if (p >= a.held) {\n"
     "        fwd_stage_slice<Cell, BF16, false>(a, part(p), nullptr, bias_s + p * bias_n);\n        continue;\n"
     "      }\n    }\n    fwd_stage_slice<Cell, BF16, kResident>(a, part(p), fwd_smem + p * slice, bias_s + p * bias_n);\n"
     "  }\n"),
    ("rnn_fwd.cuh", "    for (int p = 0; p < n_parts; ++p) fwd_part_step<Cell, BF16, kResident, kTail, kRows>(a, part(p), t, n_tiles);\n",
     "    for (int p = 0; p < n_parts; ++p) {\n      if constexpr (kStreamRest) {\n        if (p >= a.held) {\n"
     "          fwd_part_step<Cell, BF16, false, kTail, kRows>(a, part(p), t, n_tiles);\n          continue;\n"
     "        }\n      }\n      fwd_part_step<Cell, BF16, kResident, kTail, kRows>(a, part(p), t, n_tiles);\n    }\n"),
    ("rnn_fwd.cuh", "template <class Cell, bool BF16, bool kResident, int kTail>\nconstexpr auto fwd_kernel() {\n"
     "  if constexpr (Cell::kXproj) {\n    return rnn_xp_fwd_kernel<Cell, BF16, kResident, kTail>;",
     "template <class Cell, bool BF16, bool kResident, int kTail, bool kStreamRest = false>\n"
     "constexpr auto fwd_kernel() {\n  if constexpr (Cell::kXproj) {\n"
     "    return rnn_xp_fwd_kernel<Cell, BF16, kResident, kTail, kStreamRest>;"),
    ("rnn_fwd.cuh", "  int parts;     // the streams a cluster serves at most\n",
     "  int parts;     // the streams a cluster serves at most\n  int streamed;\n"),
    ("rnn_fwd.cuh", "bool fwd_whole_streams(int S, int B, int max_smem, RnnXpFwdArgs& a, FwdPlan& p) {\n"
     "  const int Q = p.clusters, w = S / Q, r = S - w * Q;\n",
     "bool fwd_whole_streams(int S, int B, int max_smem, bool stream_rest, RnnXpFwdArgs& a, FwdPlan& p) {\n"
     "  const int Q = p.clusters, w = S / Q, r = S - w * Q;\n  if (stream_rest && r == 0) return false;\n"),
    ("rnn_fwd.cuh", "  const size_t smem =\n      (parts * (slice + a.n_tiles * kGateCols) + kFwdStages * fwd_stage_floats<Cell, BF16, true>(128)) * sizeof(float);\n",
     "  const int held = stream_rest ? w : parts;\n"
     "  const size_t stage = stream_rest ? fwd_stage_floats<Cell, BF16, false>(128) : fwd_stage_floats<Cell, BF16, true>(128);\n"
     "  const size_t smem = (held * slice + (size_t)parts * a.n_tiles * kGateCols + kFwdStages * stage) * sizeof(float);\n"),
    ("rnn_fwd.cuh", "  a.rows = rest;\n  p.rows = w * B + rest;\n",
     "  a.rows = rest;\n  a.held = held;\n  p.streamed = parts - held;\n  p.rows = w * B + rest;\n"),
    ("rnn_fwd.cuh", "  p.parts = 1;\n  if constexpr (Cell::kXproj) {\n    a.parts = 1;\n",
     "  p.parts = 1;\n  p.streamed = 0;\n  if constexpr (Cell::kXproj) {\n    a.parts = 1;\n    a.held = 1;\n"),
    ("rnn_fwd.cuh", "if (S > p.clusters && p.resident && fwd_whole_streams<Cell, BF16>(S, B, max_smem, a, p)) {",
     "if (S > p.clusters && p.resident && (fwd_whole_streams<Cell, BF16>(S, B, max_smem, false, a, p) ||\n"
     "                                        fwd_whole_streams<Cell, BF16>(S, B, max_smem, true, a, p))) {"),
    ("rnn_fwd.cuh", "template <class Cell, bool BF16, bool kResident, int kTail>\ncudaError_t fwd_run(const typename Cell::Args& a, "
     "const FwdPlan& p, cudaStream_t st) {\n  auto kernel = fwd_kernel<Cell, BF16, kResident, kTail>();",
     "template <class Cell, bool BF16, bool kResident, int kTail, bool kStreamRest = false>\n"
     "cudaError_t fwd_run(const typename Cell::Args& a, const FwdPlan& p, cudaStream_t st) {\n"
     "  auto kernel = fwd_kernel<Cell, BF16, kResident, kTail, kStreamRest>();"),
    ("rnn_fwd.cuh", "  if (!p.resident) return fwd_run<Cell, BF16, false, 128>(a, p, st);\n",
     "  if (!p.resident) return fwd_run<Cell, BF16, false, 128>(a, p, st);\n  if constexpr (Cell::kXproj) {\n"
     "    if (p.streamed > 0) {\n      if (p.tail == 32) return fwd_run<Cell, BF16, true, 32, true>(a, p, st);\n"
     "      if (p.tail == 64) return fwd_run<Cell, BF16, true, 64, true>(a, p, st);\n"
     "      return fwd_run<Cell, BF16, true, 128, true>(a, p, st);\n    }\n  }\n"),
]
#: the clusters of 16 CTAs (the non-portable size) the card runs at once of
#: an xproj forward's fp32 kernel, where a CTA owns ceil(H/16) hidden columns
#: (half a tile's product columns: the GRU's 48, the LSTM's 64) and holds the
#: weight slices and biases of `parts` streams beside the 128-row ring:
#: entry points xp_fwd_clusters_of_16(parts, H, out) in gru_xp and lstm_xp
_CLUSTER_16_QUERY = """// (kernel_ab.py variant cluster-16) the clusters of 16 CTAs the card runs at once
template <class Cell>
int xp_fwd_clusters16(int parts, int H, int* out) {
  const int kp = (Cell::x_start(H) + kGateK - 1) / kGateK * kGateK;
  const size_t slice = (size_t)kp * (Cell::kTileCols / 2 + kFwdPad) + kGateCols / 2;
  const size_t smem = (parts * slice + kFwdStages * fwd_stage_floats<Cell, false, true>(128)) * sizeof(float);
  auto kernel = fwd_kernel<Cell, false, true, 128>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, smem, nullptr, &attr);
  cfg.gridDim = dim3(16);
  attr.val.clusterDim.x = 16;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

"""
#: source edits (file in csrc/, text, replacement; each text occurs once) of
#: each variant, a design of the xproj forwards (gru_xp_fwd, lstm_xp_fwd)
#: that the sources do not ship:
#: - fp32-cluster, fp32-columns: fp32 mode on the cluster forward, or on one
#:   thread a column, at every shape;
#: - stream-rest: fp32 mode on the cluster forward at G=16 too, a cluster
#:   holding its whole stream's weight slice and streaming the slice of its
#:   share of the sixteenth stream from L2 (kStreamRest);
#: - all-streamed: as stream-rest, with the whole stream's slice streamed too;
#: - cluster-a-stream: a cluster a stream where the streams outnumber the
#:   clusters at once (G=16: two waves), in both modes;
#: - tile-96: the xproj cells' fp32 mode takes a cluster's 69 rows (G=1) in
#:   one 96-row tile (the sources: 80 rows);
#: - lstm-tile-128: lstm_xp_fwd's fp32 mode takes 128-row tiles only;
#: - cluster-16: no kernel changed; the occupancy query of 16-CTA clusters
#:   added, printed before the times
VARIANTS = {
    "fp32-cluster": _FP32_CLUSTER,
    "fp32-columns": [("rnn_fwd.cuh", _RULE, "*columns = true;\n  (void)step;\n  (void)cols;")],
    "stream-rest": _FP32_CLUSTER + _STREAM_REST,
    "all-streamed": _FP32_CLUSTER + _STREAM_REST + [("rnn_fwd.cuh", "  a.held = held;\n", "  a.held = 0;\n")],
    "cluster-a-stream": _FP32_CLUSTER + [("rnn_fwd.cuh", "if (S > p.clusters && p.resident &&", "if (false &&")],
    "tile-96": [("rnn_fwd.cuh", "if (Cell::kXproj && !BF16 && p.rows <= 80) {", "if (false) {")],
    "lstm-tile-128": [("rnn_fwd.cuh", "static constexpr bool one_tile(bool bf16) { return !bf16; }",
                       "static constexpr bool one_tile(bool bf16) { return false; }")],
    "cluster-16": [
        ("rnn_fwd.cuh", "// The xproj forwards keep one thread a hidden column",
         _CLUSTER_16_QUERY + "// The xproj forwards keep one thread a hidden column"),
        ("gru_xp.cu", 'extern "C" int gru_xp_fwd_plan(',
         'extern "C" int xp_fwd_clusters_of_16(int parts, int H, int* out) {\n'
         "  return xp_fwd_clusters16<GruXpFwdCell>(parts, H, out);\n}\n\n"
         'extern "C" int gru_xp_fwd_plan('),
        ("lstm_xp.cu", 'extern "C" int lstm_xp_fwd_plan(',
         'extern "C" int xp_fwd_clusters_of_16(int parts, int H, int* out) {\n'
         "  return xp_fwd_clusters16<LstmXpFwdCell>(parts, H, out);\n}\n\n"
         'extern "C" int lstm_xp_fwd_plan('),
    ],
}

#: (family, streams, B) of each timed shape
SHAPES = [("gru", 2, 1024), ("gru", 1, 1024), ("lstm", 2, 1024), ("lstm", 1, 1024),
          ("gru_xp", 16, 128), ("lstm_xp", 16, 128), ("gru_xp", 1, 1024), ("lstm_xp", 1, 1024)]


def lib_name(family: str) -> str:
    return Path(cs.FAMILIES[family]["source"]).stem


def build_bases(roots: dict[str, Path], names: set[str]) -> dict[str, dict[str, ctypes.CDLL]]:
    """Build each base tree's sources ``csrc/<name>.cu`` into ``build/ab/<label>/``,
    every ``nvcc`` at once, and load them: ``{label: {name: library}}``."""
    procs = []
    for label, root in roots.items():
        csrc = root / "rsl_rl_tpu_torch" / "csrc"
        out_dir = cuda_build.BUILD_DIR / "ab" / label
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in sorted(names):
            out = out_dir / f"{name}.so"
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(out), str(csrc / f"{name}.cu")]
            procs.append((label, name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                             text=True)))
    libs: dict[str, dict[str, ctypes.CDLL]] = {}
    for label, name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"{label} {name} does not build:\n{log}")
        libs.setdefault(label, {})[name] = ctypes.CDLL(str(out))
    return libs


def make_variant(name: str) -> Path:
    """A copy of this tree's sources with the edits of ``VARIANTS[name]``."""
    root = cuda_build.BUILD_DIR / "variant" / name
    csrc = root / "rsl_rl_tpu_torch" / "csrc"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    for file, old, new in VARIANTS[name]:
        text = (csrc / file).read_text()
        if text.count(old) != 1:
            cs.fail(f"variant {name}: {old!r} occurs {text.count(old)} times in {file}")
        (csrc / file).write_text(text.replace(old, new))
    return root


def bind(lib: ctypes.CDLL, module, name: str) -> ctypes.CDLL:
    for fn, argtypes in module._SIGNATURES[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def print_cluster_16(label: str, libs: dict[str, ctypes.CDLL], H: int) -> None:
    """The 16-CTA occupancy query of a ``cluster-16`` build, beside the
    clusters of 8 the plan counts for one fp32 slice a CTA."""
    for family in ("gru_xp", "lstm_xp"):
        lib = libs.get(lib_name(family))
        if lib is None or not hasattr(lib, "xp_fwd_clusters_of_16"):
            continue
        counts = {}
        for parts in (1, 2):
            out = ctypes.c_int(0)
            raise_on("xp_fwd_clusters_of_16", lib.xp_fwd_clusters_of_16(parts, H, ctypes.byref(out)))
            counts[parts] = out.value
        fwd = cs.FAMILIES[family]["kernels"][0]
        eight = getattr(cs.FAMILIES[family]["module"], f"{fwd}_plan")(1, 1024, H, False)["active_clusters"]
        print(f"{label}: {fwd} fp32 with 16-CTA clusters at H={H}: clusters at once by weight slices a CTA"
              f" holds {counts}; clusters of 8 at once: {eight}")


def parse_shape(text: str) -> tuple[str, int, int]:
    family, streams, B = text.split(":")
    if family not in cs.FAMILIES:
        raise argparse.ArgumentTypeError(f"unknown family {family!r}")
    return family, int(streams), int(B)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("base_root", type=Path, nargs="?")
    parser.add_argument("--variant", nargs="+", choices=sorted(VARIANTS))
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--family", nargs="+", choices=sorted(cs.FAMILIES), help="time these families only")
    parser.add_argument("--shapes", nargs="+", type=parse_shape, metavar="FAMILY:STREAMS:B",
                        help="time these shapes in place of the main-path ones")
    args = parser.parse_args()
    if (args.base_root is None) == (args.variant is None):
        parser.error("give BASE_ROOT or --variant")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    cuda_build.build_all()
    shapes = [shape for shape in args.shapes or SHAPES if not args.family or shape[0] in args.family]
    roots = {"base": args.base_root} if args.base_root else {name: make_variant(name) for name in args.variant}
    bases = build_bases(roots, {lib_name(f) for f, _, _ in shapes})
    print(f"build: {time.perf_counter() - start:.1f} s")
    D, H, T = 15, 256, 24
    for label, libs in bases.items():
        print_cluster_16(label, libs, H)
    for seed, (family, S, B) in enumerate(shapes):
        mod = cs.FAMILIES[family]["module"]
        name = lib_name(family)
        this_lib = mod._lib(name)
        x = cs.make_inputs(family, S, T, B, D, H, seed=31 + seed)
        for bf16 in (False, True):
            for label, libs in bases.items():
                base_lib = bind(libs[name], mod, name)
                times: dict[str, list[float]] = {}
                for lib in (base_lib, this_lib, this_lib, base_lib):
                    mod._LIBS[name] = lib
                    calls, _ = cs.kernel_calls(family, x, bf16)
                    for kernel, (call, _) in calls.items():
                        times.setdefault(kernel, []).append(cs.time_ms(call, args.reps))
                mod._LIBS[name] = this_lib
                for kernel, (b0, t0, t1, b1) in times.items():
                    print(f"ab {kernel} {'G' if family.endswith('_xp') else 'S'}={S} B={B}"
                          f" {'bf16' if bf16 else 'fp32'}: {label} {b0:.4f} this {t0:.4f} this {t1:.4f}"
                          f" {label} {b1:.4f} ms; this/{label} {(t0 + t1) / (b0 + b1):.4f}")
            sys.stdout.flush()


if __name__ == "__main__":
    main()
