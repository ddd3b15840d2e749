"""Device time, per pair, of the backward in the profiled label training
steps: the whole feature extractor's gradients, the batch norms' over every
row of the batch (the program's span `deepsir.train.backward` around
`loss.backward()`; autograd launches the kernels from its own thread while
the span is open)."""
from benchmark.program_spans import device_ms_per_pair


def read(r):
    return device_ms_per_pair(r, "deepsir.train.backward")
