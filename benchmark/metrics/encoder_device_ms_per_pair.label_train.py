"""Device time, per pair, of the RandLA encoder's forward in the profiled label
training steps: fc0, the four dilated residual blocks and their max pooling
(the program's span `deepsir.randla.encoder`, `models/randla.py`). Its
backward is in `backward_device_ms_per_pair.label_train`."""
from benchmark.program_spans import device_ms_per_pair


def read(r):
    return device_ms_per_pair(r, "deepsir.randla.encoder")
