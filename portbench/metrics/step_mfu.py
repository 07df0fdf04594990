"""Model FLOPs of the window (counted from the configuration's shapes,
``portbench/work.py``) over the window's wall time times the dense peak of
the configuration's precision (fp32 outside the tensor cores, or bf16) times
the chips, in percent."""

from portbench.work import iteration_flops, peaks_of


def read(ctx):
    config = ctx.spec["config"]
    peak = peaks_of(ctx.device_name)["bf16_flops" if config["precision"] == "bf16" else "fp32_flops"]
    if peak is None:
        return None
    flops = ctx.iterations * iteration_flops(config, ctx.num_envs, ctx.obs_dim, ctx.num_actions)
    return 100.0 * flops / (ctx.window_s * peak * ctx.chips)
