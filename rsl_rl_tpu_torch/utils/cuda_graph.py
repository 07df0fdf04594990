"""Whole-iteration dispatch: one training iteration as a CUDA graph (the
port's form of the JAX runners' ``jax.jit`` of collect + update, and of the
``lax.scan`` of K of them, ``rsl_rl_tpu/runners/on_policy_runner.py``
``fuse_iteration`` / ``iterations_per_dispatch``).

A graph replays fixed addresses, so the iteration is an in-place callable
over a static state tree. :class:`IterationGraph` holds the tree's tensors
(the collect state; for the stacked runner the train state too), runs
``step(tree) -> (tree', metrics)`` on them and copies ``tree'`` back into
them, so iteration i+1 reads iteration i's result. Everything else the
iteration changes (parameters, Adam moments and count, learning rate,
normalizer moments) the algorithms update in place.

On the card the first :meth:`IterationGraph.run` is a real iteration run
eagerly on torch's capture stream (the warm-up: cuBLAS handles, the
kernels' libraries and plans), then one iteration is captured with
``torch.cuda.graph`` on that stream; every later run replays it. The
explicit generators the iteration draws from are registered with the graph
(``CUDAGraph.register_generator_state``): each replay then reads their
Philox offsets from the device and advances them as the eager calls would,
so the draws are fresh each replay and equal the eager run's. A capture or
replay error raises; nothing falls back to eager. The kernels' launch
counters (``ops/rnn_common.py`` ``LaunchCounts``) count in the Python
wrappers, which a replay does not run: the counts that the capture added are
taken back, and every replay adds them again.

On a mesh the iteration's collectives are captured with it: each rank
captures its own graph after a warm-up whose collectives create the NCCL
communicators, and the ranks' replays issue the same collectives in the
same order.

On the CPU the same in-place callable runs eagerly.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable

import numpy as np
import torch

from rsl_rl_tpu_torch.ops import gru_rnn, lstm_rnn
from rsl_rl_tpu_torch.ops.rnn_common import LaunchCounts

_COUNT_FIELDS = tuple(f.name for f in dataclasses.fields(LaunchCounts))


def launch_counters() -> tuple[LaunchCounts, ...]:
    """Every kernel family's launch counter."""
    return (gru_rnn.launch_counts, gru_rnn.xp_launch_counts, lstm_rnn.launch_counts, lstm_rnn.xp_launch_counts)


def _read_counts() -> list[list[int]]:
    return [[getattr(c, f) for f in _COUNT_FIELDS] for c in launch_counters()]


def _add_counts(counts: list[list[int]], times: int = 1) -> None:
    for counter, row in zip(launch_counters(), counts):
        for f, n in zip(_COUNT_FIELDS, row):
            setattr(counter, f, getattr(counter, f) + times * n)


def flatten(tree: Any) -> tuple[list[torch.Tensor], Callable[[list[torch.Tensor]], Any]]:
    """The tensors of a tree of dataclasses, dicts, tuples and lists, in
    order, and the function that builds a tree of the same structure (new
    containers, other leaves as they were) from a list of such tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        leaves, build = flatten([getattr(tree, n) for n in names])
        cls = type(tree)
        return leaves, lambda ls: cls(**dict(zip(names, build(ls))))
    if isinstance(tree, dict):
        keys = list(tree)
        leaves, build = flatten([tree[k] for k in keys])
        return leaves, lambda ls: dict(zip(keys, build(ls)))
    if isinstance(tree, (tuple, list)):
        parts = [flatten(v) for v in tree]
        sizes = [len(p[0]) for p in parts]
        cls = type(tree)

        def build(ls):
            out, i = [], 0
            for (_, b), n in zip(parts, sizes):
                out.append(b(ls[i:i + n]))
                i += n
            return cls(out)

        return [t for p in parts for t in p[0]], build
    return [], lambda leaves: tree


class IterationGraph:
    """One training iteration over a static state tree, replayed as a CUDA
    graph on the card and run eagerly on the CPU.

    ``step(tree) -> (tree', metrics)`` is the iteration; ``tree'`` has the
    structure of ``tree`` and ``metrics`` is a dict of tensors (scalars, or
    ``[G]`` for a study). ``generators`` are the explicit
    generators it draws from. :meth:`load` copies a tree into the static
    tensors (the first call takes a private copy), :attr:`state` is the tree
    over them, :meth:`run` runs one iteration and returns its metrics
    flattened into one tensor in the order of :attr:`metric_keys`,
    and :meth:`unpack` reads the packed metrics of several runs at once.
    ``capture_s`` and ``pool_bytes`` (the memory the capture reserved) are
    set once the graph is captured.
    """

    def __init__(self, step: Callable, device: torch.device, generators=()):
        self.step = step
        self.device = torch.device(device)
        self.generators = list(generators)
        self.metric_keys: list[str] | None = None
        self.capture_s: float | None = None
        self.pool_bytes: int | None = None
        self._leaves: list[torch.Tensor] | None = None
        self._build = None
        self._graph = None
        self._packed = None
        self._launches = None  # the captured iteration's launches, per counter

    def load(self, tree) -> None:
        """Copy ``tree`` into the static tensors, where it holds other
        tensors (what a caller assigned between iterations)."""
        leaves, build = flatten(tree)
        if self._leaves is None:
            self._leaves = [t.detach().clone().requires_grad_(t.requires_grad) for t in leaves]
            self._build = build
            return
        if [t.shape for t in leaves] != [t.shape for t in self._leaves]:
            raise ValueError("the state to load does not have the shapes of the iteration's state")
        with torch.no_grad():
            for dst, src in zip(self._leaves, leaves):
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)

    @property
    def state(self):
        """The state tree over the static tensors (new containers each call)."""
        return self._build(self._leaves)

    def _iterate(self) -> torch.Tensor:
        state, metrics = self.step(self.state)
        out, _ = flatten(state)
        with torch.no_grad():
            for dst, src in zip(self._leaves, out):
                if src is not dst:
                    dst.copy_(src)
            if self.metric_keys is None:
                self.metric_keys = list(metrics)
                self._metric_shapes = [tuple(metrics[k].shape) for k in self.metric_keys]
            return torch.cat([metrics[k].detach().to(torch.float32).reshape(-1) for k in self.metric_keys])

    def run(self) -> torch.Tensor:
        """One iteration; its packed metrics, a fresh tensor (no sync)."""
        if self._leaves is None:
            raise RuntimeError("load a state before running the iteration")
        if self.device.type != "cuda":
            return self._iterate()
        if self._graph is None:
            return self._capture()
        self._graph.replay()
        _add_counts(self._launches)
        return self._packed.clone()

    def _capture(self) -> torch.Tensor:
        """The warm-up iteration, then the capture of one iteration; returns
        the warm-up's metrics."""
        graph = torch.cuda.CUDAGraph()
        # torch's one capture stream of the process: a new stream each
        # capture would keep a cuBLAS workspace each for the process's life
        capture = torch.cuda.graph(graph)
        main, side = torch.cuda.current_stream(self.device), capture.capture_stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            packed = self._iterate()
        main.wait_stream(side)
        packed.record_stream(main)
        for gen in self.generators:
            graph.register_generator_state(gen)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = _read_counts()
        # A dead runner lives on in a reference cycle (its graph's step is
        # its bound method) until the cyclic collector frees it, and freeing
        # its graph inside this capture would invalidate the capture (torch
        # no longer collects on entering one): collect now, and not during it.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        start = time.perf_counter()
        try:
            with capture:
                self._packed = self._iterate()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - start
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        after = _read_counts()
        self._launches = [[a - b for a, b in zip(ra, rb)] for ra, rb in zip(after, before)]
        _add_counts(self._launches, -1)  # the capture launched nothing
        self._graph = graph
        return packed

    def unpack(self, packs: list[torch.Tensor]) -> list[dict[str, np.ndarray]]:
        """The metrics of runs (their :meth:`run` outputs), read to the host
        in one transfer: one ``{key: value}`` a run."""
        host = torch.stack(packs).cpu().numpy()
        out = []
        for row in host:
            metrics, off = {}, 0
            for k, shape in zip(self.metric_keys, self._metric_shapes):
                n = int(np.prod(shape))
                metrics[k] = row[off:off + n].reshape(shape)
                off += n
            out.append(metrics)
        return out

    def release(self) -> None:
        """Free the graph and its memory pool; the static tensors stay (the
        runner's state), and the next :meth:`run` captures again."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._packed = self._launches = None
