"""Milliseconds of the cyclic garbage collector's pauses an iteration over
the window: the pauses the tracer's ``gc.callbacks`` hook booked to the
window's iterations (their ``gc`` spans, host clock) over the iterations
(``portbench/program_trace.py``)."""

from portbench.program_trace import window_records


def read(ctx):
    records = window_records(ctx)
    if records is None:
        return None
    return sum(r.ms("gc") for r in records) / len(records)
