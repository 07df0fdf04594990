#!/usr/bin/env python3
"""Time the port's kernels from two source trees on one card, in turns.

    python3 kernel_ab.py BASE_ROOT [--reps 20]
    python3 kernel_ab.py --variant cluster-a-stream [--reps 20]

``BASE_ROOT`` is the root of another checkout of the repository (for example
the parent commit unpacked with ``git archive`` into ``build/base``). With
``--variant NAME`` the base is instead a copy of this tree's sources under
``build/variant/NAME/`` with the edits of ``VARIANTS[NAME]`` applied: a design
the sources do not ship, timed against the one they do. Its
``rsl_rl_tpu_torch/csrc/*.cu`` build with the flags of
``rsl_rl_tpu_torch/utils/cuda_build.py`` into ``build/ab/``, one ``nvcc`` per
source, in parallel; this tree's own kernels build as usual. Every kernel entry
point then runs at its main-path shape (``chip_smoke.py``'s inputs: the x
kernels at T=24, B=1024, D=15, H=256, S=2 and S=1; the xproj kernels at G=16,
B=128, and at G=1, B=1024, the wide-input path's shape) in fp32 and in
bf16-operand mode, timed with CUDA events in the order
base, this, this, base, so that a drift of the card during the run shows. One
line a kernel, shape and mode, with the four times and the ratio of this
tree's mean to the base's; the card's name and power limit first. Both trees'
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
from rsl_rl_tpu_torch.utils import cuda_build

#: source edits (file in csrc/, text, replacement; each text occurs once) of
#: each variant. cluster-a-stream: lstm_xp_fwd on the cluster forward in both
#: modes (fp32 ships one thread a hidden column), with a cluster a stream
#: where the streams outnumber the clusters at once (bf16 ships whole streams
#: and a share of the rest a cluster, in one wave)
VARIANTS = {
    "cluster-a-stream": [
        ("lstm_xp.cu", "if (!bf16) {", "if (false) {"),
        ("lstm_xp.cu", "return (int)rnn_x_fwd_launch<LstmXpFwdCell, true>(a, G, st);",
         "return (int)(bf16 ? rnn_x_fwd_launch<LstmXpFwdCell, true>(a, G, st)"
         " : rnn_x_fwd_launch<LstmXpFwdCell, false>(a, G, st));"),
        ("rnn_fwd.cuh", "if (S > p.clusters && p.resident && fwd_whole_streams", "if (false && fwd_whole_streams"),
    ],
}

#: (family, streams, B) of each timed shape
SHAPES = [("gru", 2, 1024), ("gru", 1, 1024), ("lstm", 2, 1024), ("lstm", 1, 1024),
          ("gru_xp", 16, 128), ("lstm_xp", 16, 128), ("gru_xp", 1, 1024), ("lstm_xp", 1, 1024)]


def lib_name(family: str) -> str:
    return Path(cs.FAMILIES[family]["source"]).stem


def build_base(root: Path) -> dict[str, ctypes.CDLL]:
    """Build the base tree's sources into ``build/ab/`` and load them."""
    csrc = root / "rsl_rl_tpu_torch" / "csrc"
    out_dir = cuda_build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(csrc.glob("*.cu")):
        out = out_dir / f"{src.stem}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(out), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"base {name} does not build:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("base_root", type=Path, nargs="?")
    parser.add_argument("--variant", choices=sorted(VARIANTS))
    parser.add_argument("--reps", type=int, default=20)
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
    base_libs = build_base(args.base_root or make_variant(args.variant))
    print(f"build: {time.perf_counter() - start:.1f} s")
    D, H, T = 15, 256, 24
    for seed, (family, S, B) in enumerate(SHAPES):
        mod = cs.FAMILIES[family]["module"]
        name = lib_name(family)
        this_lib = mod._lib(name)
        base_lib = bind(base_libs[name], mod, name)
        x = cs.make_inputs(family, S, T, B, D, H, seed=31 + seed)
        for bf16 in (False, True):
            times: dict[str, list[float]] = {}
            for label, lib in (("base", base_lib), ("this", this_lib), ("this", this_lib), ("base", base_lib)):
                mod._LIBS[name] = lib
                calls, _ = cs.kernel_calls(family, x, bf16)
                for kernel, (call, _) in calls.items():
                    times.setdefault(kernel, []).append(cs.time_ms(call, args.reps))
            mod._LIBS[name] = this_lib
            for kernel, (b0, t0, t1, b1) in times.items():
                print(f"ab {kernel} {'G' if family.endswith('_xp') else 'S'}={S} B={B} {'bf16' if bf16 else 'fp32'}:"
                      f" base {b0:.4f} this {t0:.4f} this {t1:.4f} base {b1:.4f} ms;"
                      f" this/base {(t0 + t1) / (b0 + b1):.4f}")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
