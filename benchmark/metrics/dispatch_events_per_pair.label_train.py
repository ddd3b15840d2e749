"""Device events (kernels, copies, memsets) that the profiled label training
steps (`training.train_step`) launched, per pair: how much the host
dispatches for each pair."""
from benchmark.profiling import events_per_pair as read  # noqa: F401
