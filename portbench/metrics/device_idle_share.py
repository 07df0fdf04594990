"""The share of the traced stretch in which no kernel or copy ran on the
device, in percent, averaged over the chips (``torch.profiler``, no
synchronization added). Tracing stretches the host's launches, a graph's
launch most, so on the graphed path this reads above the untraced window's
idle share."""


def read(ctx):
    if not ctx.traces:
        return None
    shares = [1.0 - t["busy_s"] / t["stretch_s"] for t in ctx.traces]
    return 100.0 * sum(shares) / len(shares)
