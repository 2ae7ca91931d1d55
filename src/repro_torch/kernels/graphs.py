"""CUDA graphs whose replays count the kernel launches they hold.

Each kernel wrapper counts its launches in module counters (the names in
its ``COUNTERS``) when Python calls it.  Under capture Python calls the
wrapper once and the kernel runs at every replay, so a plain counter
would count the capture and no replay.  ``CountedGraph.capture`` takes
back what the capture added and keeps it as the graph's launches;
``replay`` adds them once per replay.  ``chip_smoke.py`` reads the
counters around a served run, so its launches stay true when the decode
window is a graph.  Every capture is noted in ``capture_log`` (wall time
it started, seconds), which ``telemetry.compile_watch`` reads.
"""
from __future__ import annotations

import importlib
import time

import torch

# the kernel modules whose wrappers count launches
KERNEL_MODULES = ("decode_attention", "entropy", "flash_attention",
                  "ssd_scan")
# (wall time it started, seconds) of each capture in this process
capture_log: list[tuple[float, float]] = []


def _modules():
    return [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in KERNEL_MODULES]


def launch_counts() -> dict[str, int]:
    """Every counter of every kernel module, as ``{"module.name": n}``."""
    return {f"{m.__name__.rsplit('.', 1)[1]}.{c}": getattr(m, c)
            for m in _modules() for c in m.COUNTERS}


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (keys as :func:`launch_counts` gives them)."""
    for key, n in delta.items():
        mod, name = key.split(".")
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        setattr(m, name, getattr(m, name) + n)


class CountedGraph:
    """One CUDA graph and the launches its capture recorded.

    ``graph`` and ``context`` stand in for ``torch.cuda.CUDAGraph()`` and
    ``torch.cuda.graph(graph, pool=pool)`` (the tests pass stubs on the
    CPU).  A failed capture or replay raises; nothing runs uncaptured in
    its place."""

    def __init__(self, graph=None):
        self.graph = torch.cuda.CUDAGraph() if graph is None else graph
        self.launches: dict[str, int] = {}

    def capture(self, fn, *, pool=None, context=None) -> None:
        """Record ``fn`` into the graph (it does not run) and keep the
        launches it counted as this graph's, off the counters."""
        before = launch_counts()
        ctx = (torch.cuda.graph(self.graph, pool=pool) if context is None
               else context)
        started, t0 = time.time(), time.perf_counter()
        try:
            with ctx:
                fn()
        finally:
            after = launch_counts()
            add_launch_counts({k: before[k] - after[k] for k in after})
        capture_log.append((started, time.perf_counter() - t0))
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}

    def replay(self) -> None:
        self.graph.replay()
        add_launch_counts(self.launches)
