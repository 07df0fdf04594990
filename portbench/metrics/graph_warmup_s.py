"""Seconds of the eager iteration that runs before the CUDA graph's capture,
part of the set-up: from its start to the synchronize that ends it, on the
host clock (the tracer's set-up span ``graph.warmup``,
``portbench/program_trace.py``)."""

from portbench.program_trace import tracer


def read(ctx):
    trace = tracer()
    return None if trace is None else trace.setup.get("graph.warmup")
