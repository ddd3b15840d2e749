"""Each pytest-xdist worker's share of the cores for torch's threads.

Under xdist (`-n W`) every worker gets cores // W intra-op threads, at
least 1, and the processes the tests spawn inherit that count through
OMP_NUM_THREADS; without xdist torch keeps its default of one thread per
core. Left at the default, W workers start a thread per core each: with
`-n 6` on 8 cores that is 48 busy threads, and the port's six heaviest
test files took 805 s instead of 203 s in a 6-worker run. Every
tests/test_torch_*.py imports this module before its tests run.
"""
import os

import torch


def share() -> int:
    """cores // workers under xdist, else torch's current thread count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers <= 0:
        return torch.get_num_threads()
    return max(1, len(os.sched_getaffinity(0)) // workers)


THREADS = share()
torch.set_num_threads(THREADS)
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
