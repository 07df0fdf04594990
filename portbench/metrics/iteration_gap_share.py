"""The share of the window in which the device stood waiting on the host
between iterations, in percent, with no profiler running: the gaps from
each iteration's last stamp to the next one's first (the tracer's
``gap_ms``), summed over the window's iterations after its first, over the
device clock's span from the window's first stamp to its last
(``portbench/program_trace.py``)."""

from portbench.program_trace import stamped_records


def read(ctx):
    records = stamped_records(ctx)
    if records is None or len(records) < 2:
        return None
    span_ns = records[-1].last_ns - records[0].first_ns
    return 100.0 * sum(r.gap_ms for r in records[1:]) * 1e6 / span_ns
