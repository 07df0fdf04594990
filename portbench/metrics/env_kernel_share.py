"""The env steps that ran as the hand-written step kernel, in percent, the
median over the window: each iteration's ``env.kernel`` count (the kernel's
launches inside its marks, ``rsl_rl_tpu_torch/ops/nlink_step.py``) over its
``env`` span's count (its ``env.step`` calls), from the tracer's records
(``portbench/program_trace.py``). A program whose tracer counts no kernel
gives None."""

import statistics

from portbench.program_trace import window_records


def read(ctx):
    records = window_records(ctx)
    if records is None or any(not hasattr(r, "counts") or "env" not in r.spans for r in records):
        return None
    return statistics.median(100.0 * r.counts.get("env.kernel", 0) / r.spans["env"].count for r in records)
