"""The memory-replay kernels' share of their roofline in the traced stretch:
their least time (``portbench/work.py``, from the configuration's replay
shapes for the iterations traced) over the device time of the port's
kernels (the ``__global__`` functions of its CUDA sources), in percent."""

import re

from portbench.harness import ROOT
from portbench.trace import port_kernel_names
from portbench.work import peaks_of, replay_bound_ms


def read(ctx):
    if not ctx.traces:
        return None
    bound = replay_bound_ms(ctx.spec["config"], ctx.num_envs // ctx.chips, ctx.obs_dim, peaks_of(ctx.device_name))
    names = port_kernel_names(ROOT / "rsl_rl_tpu_torch" / "csrc")
    if bound is None or not names:
        return None
    pattern = re.compile(r"\b(" + "|".join(sorted(names)) + r")\b")
    kernel_s = sum(b - a for n, a, b in ctx.traces[0]["device"] if pattern.search(n)) * 1e-6
    if kernel_s == 0:
        return None
    return 100.0 * bound * 1e-3 * ctx.trace_iterations / kernel_s
