"""The device's milliseconds of an iteration's update, the median over the
window: from the stamp that ends the collection to the iteration's last, on
the GPU's clock (the tracer's ``update`` span, ``portbench/program_trace.py``)."""

from portbench.program_trace import median_ms


def read(ctx):
    return median_ms(ctx, "update")
