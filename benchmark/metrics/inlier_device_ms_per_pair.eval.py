"""Device time, per pair, of the inlier RandLA in the registration loop of the
profiled batches, one pass an iteration (the program's span
`deepsir.loop.inlier`, `models/network.py`; its loop-invariant LocSE cache
is not in it)."""
from benchmark.program_spans import device_ms_per_pair


def read(r):
    return device_ms_per_pair(r, "deepsir.loop.inlier")
