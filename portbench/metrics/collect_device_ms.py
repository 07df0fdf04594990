"""The device's milliseconds of an iteration's collection, the median over
the window: from the iteration's first stamp to the stamp that ends its
collection, both placed by the port's runner on the GPU's clock inside the
replayed graph and read with the iteration's metrics (the tracer's
``collect`` span, ``portbench/program_trace.py``)."""

from portbench.program_trace import median_ms


def read(ctx):
    return median_ms(ctx, "collect")
