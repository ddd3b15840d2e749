"""The share of the stretch on the device of the profiled label training
steps (`training.train_step`), from the first device event they launched to
the end of the last, in which no kernel, copy or memset ran (every device
event in the stretch counts as busy)."""
from benchmark.profiling import idle_pct as read  # noqa: F401
