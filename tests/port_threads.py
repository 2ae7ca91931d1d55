"""Each test worker's share of the CPU cores for PyTorch's thread pool.

pytest-xdist runs the tests in several worker processes, and each one's
PyTorch intra-op pool wants every core of the machine: six workers on
eight cores run six such pools at once, and a test made of many small
tensor ops then runs tens of times slower than it does alone (the
launcher's live fleet run, for one, spends its time in the pools'
contention, not in its work).  The port's test files call
:func:`share_cores` when they are imported: under xdist each worker
keeps its share of the cores, at least one thread; a run without
workers keeps PyTorch's default.
"""
import os

import torch


def share_cores() -> int:
    """Set this worker's PyTorch threads to its share of the cores;
    -> the thread count now in force."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))
    return torch.get_num_threads()
