"""Device events (kernels, copies, memsets) that the profiled batches
(`training.device_batch` and `Network.forward_align`) launched, per pair:
how much the host dispatches for each pair."""
from benchmark.profiling import events_per_pair as read  # noqa: F401
