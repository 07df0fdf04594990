"""The runner's host time outside the iteration proper, in milliseconds an
iteration: the window's wall time less the seconds inside the iterations'
own timers (the runner's ``history``), over the iterations."""


def read(ctx):
    return (ctx.window_s - ctx.loop_s) / ctx.iterations * 1e3
