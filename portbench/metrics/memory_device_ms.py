"""The device's milliseconds of an iteration's memory replays, the median
over the window: each launch of a replay kernel (forward, backward, weight
gradient) between two stamps on the GPU's clock, summed over the
iteration's minibatches (the tracer's ``memory`` span under ``update``,
``portbench/program_trace.py``). A program that places no such stamps
gives None."""

from portbench.program_trace import median_ms, stamped_records


def read(ctx):
    records = stamped_records(ctx)
    if records is None or not all("memory" in r.spans for r in records):
        return None
    return median_ms(ctx, "memory")
