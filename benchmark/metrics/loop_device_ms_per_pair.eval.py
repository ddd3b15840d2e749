"""Device time, per pair, of what `Network.forward_align` launched in the
profiled batches outside the backbone and head hooks: scoring, the
registration loop's searches, inlier net and pose solves (`ops/svd3.py`)."""
from benchmark.profiling import device_ms


def read(r):
    events = r.trace.events_in("bench.forward_align")
    if not events or not r.pairs:
        return None
    return (device_ms(events) - device_ms(r.trace.events_in("bench.backbone"))) / r.pairs
