"""Device time, per pair, of what the feature extractor (`models/randla.py`)
and the aggregation heads (`mlp_feat`, `mlp_att`, `mlp_proj`) launched in
the profiled batches, read under the forward hooks of those modules."""
from benchmark.profiling import device_ms


def read(r):
    events = r.trace.events_in("bench.backbone")
    return device_ms(events) / r.pairs if events and r.pairs else None
