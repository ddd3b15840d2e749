"""Device events (kernels, copies, memsets) that the training forward of the
profiled align steps launched, per pair: the backbone, scores and
descriptors under `no_grad` and the registration loop with its graph (the
program's span `deepsir.train.forward`). The host dispatches each one."""
from benchmark.program_spans import events_per_pair


def read(r):
    return events_per_pair(r, "deepsir.train.forward")
