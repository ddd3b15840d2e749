"""Device time, per pair, of the registration loop's searches in the profiled
batches: K2, or K3 where the loop needs the reverse match, five a batch
(the program's span `deepsir.loop.search`, `models/network.py`)."""
from benchmark.program_spans import device_ms_per_pair


def read(r):
    return device_ms_per_pair(r, "deepsir.loop.search")
