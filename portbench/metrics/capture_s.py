"""Seconds the capture of the iteration's CUDA graph took (the port's
``IterationGraph.capture_s``), part of the set-up."""


def read(ctx):
    return ctx.capture_s
