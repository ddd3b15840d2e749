"""Device time, per pair, of the RandLA decoder's forward in the profiled label
training steps: `decoder_0` and the four stages of upsampling, concatenation
and 1x1 Dense (the program's span `deepsir.randla.decoder`,
`models/randla.py`). Its backward is in
`backward_device_ms_per_pair.label_train`."""
from benchmark.program_spans import device_ms_per_pair


def read(r):
    return device_ms_per_pair(r, "deepsir.randla.decoder")
