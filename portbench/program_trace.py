"""The port's own records of a run (``rsl_rl_tpu_torch/utils/trace.py``), as
the per-layer readers take them: in rank 0's process, after the run, the
window's iterations from the tracer's ring.

The runner numbers an iteration from its last on every ``learn`` call (the
checked steps all read 0), so the window is selected by each record's
ordinal among the process's iterations: the checked steps and the warm-up
run first, so the window's first is ``CHECK_STEPS`` plus the mix's
``warmup_iterations``, and it holds ``ctx.iterations``. A program without
the tracer, or a ring that lacks one of them, gives None, and so do the
readers.
"""

from __future__ import annotations

import importlib
import statistics

from portbench.harness import CHECK_STEPS

TRACER = "rsl_rl_tpu_torch.utils.trace"


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        return importlib.import_module(TRACER)
    except ImportError:
        return None


def window_records(ctx) -> list | None:
    """The window's records in order, or None."""
    trace = tracer()
    if trace is None:
        return None
    first = CHECK_STEPS + ctx.spec["mix"]["warmup_iterations"]
    found = {r.index: r for r in trace.records if first <= r.index < first + ctx.iterations}
    if len(found) != ctx.iterations:
        return None
    return [found[i] for i in range(first, first + ctx.iterations)]


def stamped_records(ctx) -> list | None:
    """The window's records where every one carries its device stamps."""
    records = window_records(ctx)
    if not records or any(r.first_ns is None for r in records):
        return None
    return records


def median_ms(ctx, *names: str) -> float | None:
    """The median over the window of each iteration's summed milliseconds of
    the stamped spans ``names``."""
    records = stamped_records(ctx)
    if records is None:
        return None
    return statistics.median(sum(r.ms(n) for n in names) for r in records)
