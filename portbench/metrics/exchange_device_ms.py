"""The device's milliseconds of an iteration's collectives, the median over
the window of rank 0's: each collective of the mesh (the normalizers' sums
in the collection; the window gather and the gradient and metric sums in
the update) between two stamps on the GPU's clock, so a collective's wait
for the other ranks is inside it (the tracer's ``exchange.collect`` and
``exchange.update`` spans, ``portbench/program_trace.py``)."""

from portbench.program_trace import median_ms


def read(ctx):
    return median_ms(ctx, "exchange.collect", "exchange.update")
