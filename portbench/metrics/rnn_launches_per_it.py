"""Launches of the memory-replay kernels in the window (the port's launch
counters, which add a graph replay's captured launches back) per iteration."""


def read(ctx):
    if not ctx.launches:
        return None
    return ctx.launches / ctx.iterations
