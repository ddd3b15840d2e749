"""Device time, per pair, of the loss's forward in the profiled feat training
steps: the tiled circle loss and the detector term (`losses/detdes.py`; the
program's span `deepsir.train.loss`). Its backward is in
`backward_device_ms_per_pair.train`."""
from benchmark.program_spans import device_ms_per_pair


def read(r):
    return device_ms_per_pair(r, "deepsir.train.loss")
