"""Device events that the backward of the profiled align steps launched, per
pair: the inlier net's and the Kabsch solves' gradients (the program's span
`deepsir.train.backward`; autograd launches them from its own thread)."""
from benchmark.program_spans import events_per_pair


def read(r):
    return events_per_pair(r, "deepsir.train.backward")
