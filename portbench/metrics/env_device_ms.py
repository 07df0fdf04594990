"""The device's milliseconds of an iteration's env steps, the median over
the window: each ``env.step`` of the collection between two stamps on the
GPU's clock, summed over the iteration's steps (the tracer's ``env`` span,
``portbench/program_trace.py``)."""

from portbench.program_trace import median_ms


def read(ctx):
    return median_ms(ctx, "env")
