"""The port's own spans in a profiled stretch, for the per-layer metrics
that read a layer inside the program.

`deepsir_tpu_torch.utils.profiling.span` opens a host range named
`deepsir.<layer>` around each layer's work while a profiler runs. The
profiler records it as a host operation (category `cpu_op`), so it reaches
the readers among the trace's host operations (`Trace.host_ops`), not among
the benchmark's own spans. A device event belongs to a program span, as to
the benchmark's, when the host call that launched it ran inside the span;
the backward's kernels, launched from autograd's thread while the main
thread waits in `loss.backward()`, fall in `deepsir.train.backward`. A
program without the spans (the commit before they were added) leaves
nothing to read, and every reader here then gives None.
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, Optional

from benchmark.profiling import DeviceEvent, Readings, Trace, device_ms

PREFIX = "deepsir."


def program_trace(trace: Trace) -> Trace:
    """`trace`'s device events and launches, with the program's spans as
    its spans (the ranges of one name never overlap: a span is never
    opened inside itself)."""
    spans = defaultdict(list)
    for name, start, end in trace.host_ops:
        if name.startswith(PREFIX):
            spans[name].append((start, end))
    return Trace(trace.device, trace.launches, dict(spans))


def events(r: Readings, name: str) -> List[DeviceEvent]:
    """The profiled units' device events launched inside the program span
    `name`."""
    return program_trace(r.trace).events_in(name)


def device_ms_per_pair(r: Readings, name: str) -> Optional[float]:
    mine = events(r, name)
    return device_ms(mine) / r.pairs if mine and r.pairs else None


def events_per_pair(r: Readings, name: str) -> Optional[float]:
    mine = events(r, name)
    return len(mine) / r.pairs if mine and r.pairs else None

