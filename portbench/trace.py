"""Reading a ``torch.profiler`` trace of a steady stretch of training: the
device's busy intervals, its operations by name, and the idle gaps labelled
by what the host was doing. No synchronization is added inside the stretch.
"""

from __future__ import annotations

import re
from contextlib import ExitStack
from pathlib import Path

#: the label of a gap in which the host ran no traced operation (Python)
HOST_PYTHON = "host python"
STRETCH = "portbench.stretch"
#: the longest idle gaps that are labelled
LABELLED_GAPS = 10


def port_kernel_names(csrc: Path) -> set[str]:
    """The ``__global__`` functions of the port's CUDA sources."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")
    return {m for path in csrc.glob("*.cu*") for m in pattern.findall(path.read_text())}


def union_s(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` (microseconds) that the intervals cover."""
    covered, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            covered += b - a
            end = b
    return covered * 1e-6


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The sub-intervals of ``[lo, hi]`` that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def trace_stretch(fn, spans: dict, device) -> dict:
    """Profile ``fn()`` (whole iterations ending in a read of their
    metrics) with the host calls of ``spans`` (``{label: (object, attribute)}``)
    wrapped in spans; returns the stretch's summary: its seconds, the device
    operations ``(name, start_us, end_us)``, the busy seconds, and the idle
    longest idle gaps, longest first, labelled by the innermost host span or
    operation covering each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with ExitStack() as restore:
        for label, (obj, attr) in spans.items():
            own = attr in vars(obj)
            fn_attr = getattr(obj, attr)

            def wrapped(*args, _fn=fn_attr, _label=label, **kwargs):
                with record_function(_label):
                    return _fn(*args, **kwargs)

            setattr(obj, attr, wrapped)
            if own:
                restore.callback(setattr, obj, attr, fn_attr)
            else:
                restore.callback(delattr, obj, attr)
        cuda = torch.device(device).type == "cuda"
        activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
        with profile(activities=activities) as prof:
            with record_function(STRETCH):
                fn()
                if cuda:
                    torch.cuda.synchronize(device)
    events = prof.events()
    stretch = [e for e in events if e.name == STRETCH and e.device_type == DeviceType.CPU]
    lo, hi = stretch[0].time_range.start, stretch[0].time_range.end
    # the host spans are mirrored on the device's timeline as annotations
    labels = {STRETCH, *spans}
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA and e.name not in labels
              and e.time_range.end > lo and e.time_range.start < hi]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and e.name != STRETCH]
    busy = [(a, b) for _, a, b in device]
    labelled = []
    for a, b in sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        mid = 0.5 * (a + b)
        covering = [(e - s, n) for n, s, e in host if s <= mid <= e]
        labelled.append((min(covering)[1] if covering else HOST_PYTHON, (b - a) * 1e-6))
    return {"stretch_s": (hi - lo) * 1e-6, "busy_s": union_s(busy, lo, hi), "device": device, "gaps": labelled}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps."""
    by_name: dict[str, float] = {}
    for name, a, b in summary["device"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in summary["gaps"][:top]]}
