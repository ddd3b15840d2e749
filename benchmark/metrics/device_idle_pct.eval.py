"""The share of the stretch on the device of the profiled batches
(`training.device_batch` and `Network.forward_align`), from the first device
event they launched to the end of the last, in which no kernel, copy or
memset ran (every device event in the stretch counts as busy)."""
from benchmark.profiling import idle_pct as read  # noqa: F401
