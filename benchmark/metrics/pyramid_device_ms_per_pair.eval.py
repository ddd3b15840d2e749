"""Device time, per pair, of what `training.device_batch` launched in the
profiled batches: the host-to-device copy and both clouds' index pyramids
(`ops/pyramid.py` -> `ops/knn.py` -> K1)."""
from benchmark.profiling import device_ms


def read(r):
    events = r.trace.events_in("bench.device_batch")
    return device_ms(events) / r.pairs if events and r.pairs else None
