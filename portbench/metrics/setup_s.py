"""Seconds from the process's start to the first timed iteration: building
(on a checkout's first run, compiling) the kernels, the env, the runner and
its weights, the checked steps and, on the graphed path, the capture."""


def read(ctx):
    return ctx.setup_s
