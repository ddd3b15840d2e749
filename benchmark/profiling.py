"""The traced run: the benchmark's own spans around its calls into the port,
`torch.profiler` over the steady units (batches or steps; the mix's
`profile_batches` or `profile_steps`) in the middle of the window, and the reduction of the trace to what the per-layer metric
readers read.

Spans: `bench.unit` around each profiled batch or step, `bench.device_batch`,
`bench.forward_align`, `bench.train_step` around those calls, and forward
hooks on the network's modules (`bench.backbone` on the feature extractor
and the aggregation heads, `bench.inlier` on the inlier net). A device
event (kernel, copy or memset) belongs to a span when the host call that
launched it ran inside the span.
"""
from __future__ import annotations

import json
from bisect import bisect_right
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."


class DeviceEvent(NamedTuple):
    name: str
    start: float            # microseconds, the trace's clock
    dur: float
    corr: int               # correlation id of the launching host call


class Trace:
    """Device events, the host time of each launch, the benchmark's spans
    and the host operations, from one profiled stretch."""

    def __init__(self, device: Sequence[DeviceEvent], launches: Dict[int, float],
                 spans: Dict[str, List[Tuple[float, float]]],
                 host_ops: Sequence[Tuple[str, float, float]] = ()):
        self.device = sorted(device, key=lambda e: e.start)
        self.launches = launches
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self.host_ops = sorted(host_ops, key=lambda o: o[1])
        self._starts = {k: [s for s, _ in v] for k, v in self.spans.items()}
        self._op_starts = [o[1] for o in self.host_ops]

    def in_span(self, name: str, ts: Optional[float]) -> bool:
        """Whether host time `ts` lies in one of the spans called `name`
        (spans of one name never overlap)."""
        if ts is None or name not in self.spans:
            return False
        i = bisect_right(self._starts[name], ts) - 1
        return i >= 0 and ts <= self.spans[name][i][1]

    def events_in(self, name: str) -> List[DeviceEvent]:
        """The device events launched inside a span called `name`."""
        return [e for e in self.device if self.in_span(name, self.launches.get(e.corr))]

    def window(self) -> Tuple[float, float]:
        """The units' stretch on the device: from the start of the first
        device event the units launched to the end of the last one. It opens
        on the device and not at the first unit's host call, so work still
        in flight from the batch before is not counted as the units' idle
        time."""
        mine = self.events_in(SPAN_PREFIX + "unit")
        if not mine:
            raise ValueError("the trace holds no profiled unit with device work")
        return mine[0].start, max(e.start + e.dur for e in mine)

    def busy(self, lo: float, hi: float) -> Tuple[float, List[Tuple[float, float]]]:
        """(microseconds some device event runs within [lo, hi], the idle
        gaps there)."""
        merged: List[List[float]] = []
        for e in self.device:
            s, t = max(e.start, lo), min(e.start + e.dur, hi)
            if t <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        gaps, cursor = [], lo
        for s, t in merged:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, t)
        if hi > cursor:
            gaps.append((cursor, hi))
        return sum(t - s for s, t in merged), gaps

    def host_label(self, ts: float) -> str:
        """The innermost benchmark span holding host time `ts`, and the host
        operation that began last before it."""
        best, width = "outside the spans", float("inf")
        for name, spans in self.spans.items():
            if self.in_span(name, ts):
                i = bisect_right(self._starts[name], ts) - 1
                if spans[i][1] - spans[i][0] < width:
                    best, width = name, spans[i][1] - spans[i][0]
        i = bisect_right(self._op_starts, ts) - 1
        return f"{best} / {self.host_ops[i][0]}" if i >= 0 else best


def parse_chrome_trace(path) -> Trace:
    """A Trace from `torch.profiler`'s exported chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, launches, spans, host_ops = [], {}, defaultdict(list), []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args", {})
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(DeviceEvent(ev["name"], ts, dur, int(args.get("correlation", -1))))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[int(args["correlation"])] = ts
        elif cat == "user_annotation" and ev["name"].startswith(SPAN_PREFIX):
            spans[ev["name"]].append((ts, ts + dur))
        elif cat == "cpu_op":
            host_ops.append((ev["name"], ts, ts + dur))
    return Trace(device, launches, dict(spans), host_ops)


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, at most `width` characters."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    name = name[:cut].rstrip() if cut > 0 else name
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(trace: Trace, lo: float, hi: float, gaps) -> Dict:
    """The ten device operations that took most time in [lo, hi], and the
    idle time there by what the host was doing when each gap began, in
    seconds."""
    ops = defaultdict(float)
    for e in trace.device:
        s, t = max(e.start, lo), min(e.start + e.dur, hi)
        if t > s:
            ops[short(e.name)] += (t - s) * 1e-6
    idle = defaultdict(float)
    for s, t in gaps:
        idle[trace.host_label(s)] += (t - s) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


class Readings(NamedTuple):
    """What a metric reader gets: the units' own device events (`trace`,
    for attributing device time to spans), the whole trace (`every`), the
    units' count and pairs, their stretch on the device and the time in it
    that some device event ran (microseconds), and the cell's configuration
    and traffic. Build it with `readings`."""
    trace: Trace
    every: Trace
    units: int
    pairs: int
    window: Tuple[float, float]
    busy_us: float
    model: Dict
    forward: Dict
    traffic: Dict

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def readings(trace: Trace, batch: int, model: Dict, forward: Dict, traffic: Dict) -> Readings:
    """The Readings of a trace whose units each carry `batch` pairs. Device
    time is attributed to spans over the units' own device events only (a
    batch dispatched after the last unit, before the profiler stopped, is
    not read); the busy time counts every device event within the units'
    stretch on the device, whoever launched it. The units are counted in
    the trace itself."""
    units = len(trace.spans.get(SPAN_PREFIX + "unit", []))
    mine = Trace(trace.events_in(SPAN_PREFIX + "unit"), trace.launches, trace.spans,
                 trace.host_ops)
    lo, hi = mine.window()
    busy, _ = trace.busy(lo, hi)
    return Readings(mine, trace, units, units * batch, (lo, hi), busy, model, forward, traffic)


def device_ms(events: Sequence[DeviceEvent]) -> float:
    return sum(e.dur for e in events) * 1e-3


def named(events: Sequence[DeviceEvent], names: Sequence[str]) -> List[DeviceEvent]:
    """The events whose name contains one of `names`."""
    return [e for e in events if any(n in e.name for n in names)]


# Readers that several per-layer metrics share: each metric's file under
# metrics/ imports one of these as its `read`.

def idle_pct(r: Readings) -> Optional[float]:
    """The share of the units' stretch on the device in which no kernel,
    copy or memset ran."""
    span = r.window[1] - r.window[0]
    return 100.0 * (1.0 - r.busy_us / span) if span > 0 else None


def events_per_pair(r: Readings) -> Optional[float]:
    """Device events (kernels, copies, memsets) the profiled units launched,
    per pair."""
    events = r.trace.events_in(SPAN_PREFIX + "unit")
    return len(events) / r.pairs if events and r.pairs else None


def mfu_pct(r: Readings) -> Optional[float]:
    """Model operations of the profiled units (work/model.py, from the
    shapes) per second of their stretch on the device, over the card's
    fp32-grade peak (peaks.FP32_GRADE_FLOPS): no implementation at fp32
    grade reads above 100%."""
    from benchmark import peaks
    from benchmark.work import model
    if not r.pairs or r.window_s <= 0:
        return None
    flops = model.per_pair(r.model, r.forward, r.traffic) * r.pairs
    return 100.0 * flops / r.window_s / peaks.FP32_GRADE_FLOPS


class SpanHooks:
    """Forward hooks that open a profiler span around modules' calls."""

    def __init__(self):
        self.handles = []

    def add(self, module, name: str) -> None:
        import torch
        stack = []

        def pre(_module, _args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def post(_module, _args, _out):
            stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


class Profiler:
    """torch.profiler over the units chosen by the driver: `start` and
    `stop` inside the window; after it, `finish` writes the trace under the
    checkout's cache directory, reads it back and deletes it."""

    def __init__(self, trace_path):
        self.path = trace_path
        self.prof = None
        self.running = False

    @staticmethod
    def _activities():
        import torch
        return [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def warm_up(self, device) -> None:
        """Profile one small device operation, so that the tracer's own
        start-up falls in the set-up and not in the profiled units."""
        import torch
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1, device=device).add_(1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def start(self) -> None:
        import torch
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self.running = True

    def stop(self) -> None:
        if self.running:
            self.prof.stop()
            self.running = False

    def finish(self) -> Trace:
        if self.prof is None:
            raise RuntimeError("the window closed before the profiled units began")
        self.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        try:
            return parse_chrome_trace(self.path)
        finally:
            self.path.unlink(missing_ok=True)
