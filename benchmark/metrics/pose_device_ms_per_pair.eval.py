"""Device time, per pair, of the registration loop's pose solves in the
profiled batches: the weighted Kabsch (`ops/svd3.py`, the Jacobi SVD) and the
SE(3) updates, once an iteration (the program's span `deepsir.loop.pose`)."""
from benchmark.program_spans import device_ms_per_pair


def read(r):
    return device_ms_per_pair(r, "deepsir.loop.pose")
