"""Env-steps per second: every env-step the window completed, over every
rank's envs, divided by the window's whole wall time (host clock, ended by
a synchronize). The reference's ``Perf/total_fps`` over the window."""


def read(ctx):
    return ctx.env_steps / ctx.window_s
