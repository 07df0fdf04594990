"""The 95th percentile of the window's iteration times in milliseconds, each
from the end of the iteration before (the window's start for the first) to
the runner's logging of it: the runner's host work is inside it. For the
cells whose windows hold some hundreds of iterations."""

import statistics


def read(ctx):
    if len(ctx.iteration_s) < 2:
        return None
    return statistics.quantiles(ctx.iteration_s, n=20, method="inclusive")[18] * 1e3
