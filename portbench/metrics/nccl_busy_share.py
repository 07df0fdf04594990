"""The share of the traced stretch's device time spent in NCCL kernels, in
percent, averaged over the chips."""


def read(ctx):
    shares = []
    for t in ctx.traces:
        total = sum(b - a for _, a, b in t["device"])
        nccl = sum(b - a for n, a, b in t["device"] if n.startswith("nccl"))
        if total and nccl:
            shares.append(nccl / total)
    return 100.0 * sum(shares) / len(shares) if shares else None
