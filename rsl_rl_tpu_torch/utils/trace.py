"""The port's tracer: where an iteration's time goes, recorded by the
program itself, on the device's clock and the host's.

Everything lives at module level and in memory; nothing is written to disk,
and readers (the benchmark's, the tests') take the records from here.

- :data:`records`, a ring of one :class:`Record` an iteration (the last
  :data:`RING`), opened by the runners' loop (``runners/training_loop.py``).
  A record holds the iteration's identifiers, the runner's number (which a
  new ``learn`` call starts again from its last, as the runners count) and
  its ordinal among the process's iterations (:attr:`Record.index`,
  unique), and each span by name with its duration and its parent (the
  iteration, then a phase).
- **Device stamps.** Inside an iteration the program marks points
  (:func:`begin_iteration`, :func:`end_collection`, :func:`end_iteration`,
  and :func:`interval` around each ``env.step`` and each collective of
  ``parallel/mesh.py``). On CUDA a mark launches ``csrc/stamp.cu``, one
  thread storing the GPU's nanosecond timer into a slot of the iteration's
  int64 buffer, so it costs no host call beyond its launch and no
  synchronization; a CUDA graph captures the marks with the iteration and
  ``IterationGraph`` carries each replay's buffer home with its metrics. On
  the CPU a mark reads the host clock. :func:`book` turns an iteration's
  marks into its spans: ``iteration`` (first to last mark), ``collect``
  (first mark to the end of collection), ``update`` (the rest), ``env``
  (the env steps), ``exchange.collect`` / ``exchange.update`` (the
  collectives on either side), the host-env window's device phases ``act``
  and ``process``, and the record's ``gap_ms``: from the previous
  iteration's last mark on that clock to this one's first, the time the
  device stood waiting on the host.
- **Counts** (:func:`count`): a kernel's launches inside the iteration's
  marks (``env.kernel``, the env step kernel's, ``ops/nlink_step.py``),
  captured with them and booked as the record's :attr:`Record.counts`.
- **Host spans** (:func:`span`): the host clock's seconds of ``alg.collect``,
  ``alg.update``, ``dispatch.replay``, ``dispatch.read_metrics`` and
  ``runner.log``, each also a ``torch.profiler.record_function`` range while
  a profiler runs (otherwise one check). A range that encloses device work
  takes one of these labels, which the benchmark's trace reader leaves out of
  the device's operations; a new name (``gc``) is for host-only work. The
  host-env window's ``to_host``, ``env_step`` and ``to_device`` are
  host-clock phases (:func:`host_phase`) that emit no range.
- **Garbage collection**: a ``gc.callbacks`` hook books the cyclic
  collector's pauses to the running iteration (``gc``), as a ``gc`` range
  while a profiler runs.
- :data:`setup`: set-up spans by name, each its latest seconds
  (``graph.warmup``, ``graph.capture``).
- :class:`LaunchCounts`, the kernels' launch counters (instances in
  ``ops/gru_rnn.py`` and ``ops/lstm_rnn.py``, read by
  ``utils/cuda_graph.py`` ``launch_counters``).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time
from collections import deque
from dataclasses import dataclass, field

import torch

#: iterations the ring keeps (more than any benchmark window holds)
RING = 4096
#: marks an iteration may place
STAMP_SLOTS = 2048
BEGIN, END = "begin", "end"


@dataclass
class LaunchCounts:
    """Launches of each kernel since the last :meth:`reset`."""

    fwd_launches: int = 0
    bwd_launches: int = 0
    wgrad_launches: int = 0

    def reset(self) -> None:
        self.fwd_launches = self.bwd_launches = self.wgrad_launches = 0


@dataclass
class Span:
    """A span of a record: its parent span, its milliseconds summed over its
    ``count`` occurrences, and its clock (``"stamp"``: the iteration's marks,
    ``"host"``: the host clock)."""

    parent: str | None
    clock: str
    ms: float = 0.0
    count: int = 0


@dataclass
class Record:
    """One iteration: the runner's number for it, its ordinal among the
    process's iterations, its spans by name and, once its marks are booked,
    the clock they read (the device's), its first and last mark (ns), the
    gap before it (ms; None for the first iteration on that clock), how many
    marks it placed, whether they never go back in time, and the counts
    (:func:`count`) booked with its marks."""

    iteration: int
    index: int
    spans: dict[str, Span] = field(default_factory=dict)
    clock: str | None = None
    first_ns: int | None = None
    last_ns: int | None = None
    gap_ms: float | None = None
    marks: int = 0
    ordered: bool | None = None
    counts: dict[str, int] = field(default_factory=dict)

    def add(self, name: str, ms: float, parent: str | None = "iteration", clock: str = "host") -> None:
        span = self.spans.get(name)
        if span is None:
            span = self.spans[name] = Span(parent, clock)
        span.ms += ms
        span.count += 1

    def ms(self, name: str) -> float:
        """The span's milliseconds (0 where the iteration had none)."""
        span = self.spans.get(name)
        return 0.0 if span is None else span.ms


records: deque[Record] = deque(maxlen=RING)
setup: dict[str, float] = {}

_opened = 0  # records opened in this process
_current: Record | None = None
_stamps: Stamps | None = None
_finished: Stamps | None = None
_last_ns: dict[str, int] = {}
_stamp_fn = None
_gc_start: float | None = None
_gc_range = None


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _on_gc(phase: str, info: dict) -> None:
    global _gc_start, _gc_range
    if phase == "start":
        _gc_start = time.perf_counter()
        if _profiling():
            _gc_range = torch.profiler.record_function("gc")
            _gc_range.__enter__()
        return
    if _gc_range is not None:
        _gc_range.__exit__(None, None, None)
        _gc_range = None
    if _gc_start is not None and _current is not None:
        _current.add("gc", (time.perf_counter() - _gc_start) * 1e3)
    _gc_start = None


# ---------------------------------------------------------------- records


def open_iteration(iteration: int) -> Record:
    """A new record for ``iteration``, appended to the ring; it becomes the
    one host spans and collector pauses are booked to."""
    global _opened
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    record = Record(iteration, _opened)
    _opened += 1
    records.append(record)
    focus(record)
    return record


def focus(record: Record | None) -> None:
    """Book host spans and collector pauses to ``record`` from now on."""
    global _current
    _current = record


def current() -> Record | None:
    return _current


@contextlib.contextmanager
def span(name: str, parent: str | None = "iteration", book: bool = True):
    """A host span: a ``record_function`` range while a profiler runs, and
    (with ``book``) its host-clock milliseconds added to the current record."""
    rf = torch.profiler.record_function(name) if _profiling() else None
    start = time.perf_counter()
    if rf is not None:
        rf.__enter__()
    try:
        yield
    finally:
        if rf is not None:
            rf.__exit__(None, None, None)
        if book and _current is not None:
            _current.add(name, (time.perf_counter() - start) * 1e3, parent)


@contextlib.contextmanager
def host_phase(name: str, parent: str = "collect"):
    """A host-clock phase added to the current record; emits no range."""
    start = time.perf_counter()
    try:
        yield
    finally:
        if _current is not None:
            _current.add(name, (time.perf_counter() - start) * 1e3, parent)


# ----------------------------------------------------------------- stamps


def _launch_stamp(address: int) -> None:
    global _stamp_fn
    if _stamp_fn is None:
        from rsl_rl_tpu_torch.utils.cuda_build import load_library

        fn = load_library("stamp").stamp
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _stamp_fn = fn
    err = _stamp_fn(address, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the stamp kernel's launch failed with cudaError_t {err}")


class Stamps:
    """The marks one run of an iteration places: their labels ``(name,
    BEGIN | END)`` in order and, on CUDA, the int64 buffer the stamp kernel
    writes (one slot a mark; allocated with the iteration, so a graph
    captures it), on the CPU the host clock's readings (ns); and the counts
    (:func:`count`) placed between them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.clock = str(self.device)
        self.labels: list[tuple[str, str]] = []
        self.cuda = self.device.type == "cuda"
        self.buffer = torch.empty(STAMP_SLOTS, dtype=torch.int64, device=self.device) if self.cuda else None
        self.host: list[int] = []
        self.counts: dict[str, int] = {}

    def mark(self, name: str, edge: str) -> None:
        slot = len(self.labels)
        if slot == STAMP_SLOTS:
            raise RuntimeError(f"an iteration placed more than {STAMP_SLOTS} stamps")
        self.labels.append((name, edge))
        if self.cuda:
            _launch_stamp(self.buffer.data_ptr() + slot * self.buffer.element_size())
        else:
            self.host.append(time.perf_counter_ns())

    def values(self) -> torch.Tensor:
        """The marks as an int64 tensor on the device (no sync)."""
        if self.cuda:
            return self.buffer[:len(self.labels)]
        return torch.tensor(self.host, dtype=torch.int64)

    def read(self) -> list[int]:
        """The marks on the host (one transfer from the card)."""
        return self.host if not self.cuda else self.values().tolist()


def begin_iteration(device) -> None:
    """Start an iteration's marks on ``device`` with its first."""
    global _stamps, _finished
    _finished = None
    _stamps = Stamps(device)
    _stamps.mark("iteration", BEGIN)


def end_collection() -> None:
    """Mark the end of the iteration's collection."""
    if _stamps is not None:
        _stamps.mark("collect", END)


def end_iteration() -> None:
    """Place the iteration's last mark; :func:`take_stamps` returns them."""
    global _stamps, _finished
    if _stamps is not None:
        _stamps.mark("iteration", END)
    _finished, _stamps = _stamps, None


def count(name: str) -> None:
    """Add one to the count ``name`` of the iteration's marks (a kernel's
    launch inside it); outside an iteration's marks, nothing."""
    if _stamps is not None:
        _stamps.counts[name] = _stamps.counts.get(name, 0) + 1


def take_stamps() -> Stamps | None:
    """The marks of the iteration ended last and not taken yet, else None."""
    global _finished
    out, _finished = _finished, None
    return out


class _Interval:
    __slots__ = ("stamps", "name")

    def __init__(self, stamps: Stamps, name: str):
        self.stamps, self.name = stamps, name

    def __enter__(self):
        self.stamps.mark(self.name, BEGIN)

    def __exit__(self, *exc):
        self.stamps.mark(self.name, END)


_IDLE = contextlib.nullcontext()


def interval(name: str):
    """Marks around a block of an iteration (``env``, ``exchange``, ``act``,
    ``process``); outside an iteration's marks, nothing."""
    return _IDLE if _stamps is None else _Interval(_stamps, name)


def book(record: Record | None, labels: list, ns, clock: str, counts: dict[str, int] | None = None) -> None:
    """Turn an iteration's marks (``labels`` and their ``ns`` readings on
    ``clock``) into ``record``'s stamped spans and gap (module docstring),
    and add its ``counts``; without a record (an iteration run outside the
    loop) nothing."""
    if record is None or not labels:
        return
    for name, n in (counts or {}).items():
        record.counts[name] = record.counts.get(name, 0) + n
    ns = [int(t) for t in ns]
    split = next((i for i, (name, _) in enumerate(labels) if name == "collect"), len(ns) - 1)
    first, last = ns[0], ns[-1]
    previous = _last_ns.get(clock)
    record.clock, record.first_ns, record.last_ns = clock, first, last
    record.marks, record.ordered = len(ns), all(a <= b for a, b in zip(ns, ns[1:]))
    record.gap_ms = None if previous is None else (first - previous) * 1e-6
    _last_ns[clock] = last
    record.add("iteration", (last - first) * 1e-6, None, "stamp")
    record.add("collect", (ns[split] - first) * 1e-6, "iteration", "stamp")
    record.add("update", (last - ns[split]) * 1e-6, "iteration", "stamp")
    opened: dict[str, list[int]] = {}
    for i, ((name, edge), t) in enumerate(zip(labels, ns)):
        if name in ("iteration", "collect"):
            continue
        if edge == BEGIN:
            opened.setdefault(name, []).append(t)
            continue
        phase = "collect" if i <= split else "update"
        label = f"exchange.{phase}" if name == "exchange" else name
        record.add(label, (t - opened[name].pop()) * 1e-6, phase, "stamp")
