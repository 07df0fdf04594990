"""Build the port's CUDA sources into shared libraries and load them.

Each ``rsl_rl_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into ``build/<name>-<hash>.so`` at the repository root, with a
plain C interface bound through ``ctypes``; the ``*.cuh`` headers there hold
code the sources share. The hash covers every source and header in ``csrc/``
and the compiler flags, so a build is reused until something
changes. All sources compile in parallel, one ``nvcc`` each. Nothing here runs
at import time: the first :func:`load_library` call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: dict[str, ctypes.CDLL] = {}
#: ``{source name: {"seconds": float, "ptxas": str}}`` of builds this process ran
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_sources_hash()}.so"


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no current build, in parallel.

    Raises ``RuntimeError`` with the compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {p.stem: (p, _target(p.stem)) for p in sorted(CSRC_DIR.glob("*.cu"))}
    procs = {}
    for name, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(tmp), str(src)]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
            time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp, out, start) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"seconds": time.perf_counter() - start, "ptxas": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return {name: out for name, (_, out) in targets.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            path = build_all()[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
