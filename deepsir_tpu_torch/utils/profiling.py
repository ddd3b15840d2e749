"""Step tracing and anomaly detection for the train command
(deepsir_tpu/utils/profiling.py).

`StepTracer.maybe_trace(step)` traces steps [start, start + num_steps)
with `torch.profiler` (CPU and, on a card, CUDA activity) when
DEEPSIR_PROFILE names a directory, and writes a Chrome trace there;
otherwise it does nothing. `enable_debug_mode` turns on autograd's anomaly
detection, which names the operation whose backward produced a NaN.
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

import torch

_logger = logging.getLogger("profiling")


def enable_debug_mode() -> None:
    torch.autograd.set_detect_anomaly(True)
    _logger.info("debug mode: autograd anomaly detection enabled")


class StepTracer:
    """Traces a window of steps with torch.profiler (see the module doc)."""

    def __init__(self, trace_dir: Optional[str] = None, start: int = 10, num_steps: int = 3):
        self.trace_dir = trace_dir or os.environ.get("DEEPSIR_PROFILE") or None
        self.start = start
        self.num_steps = num_steps
        self._profiler: Optional[torch.profiler.profile] = None

    @contextlib.contextmanager
    def maybe_trace(self, step: int) -> Iterator[bool]:
        active = self.trace_dir is not None and self.start <= step < self.start + self.num_steps
        if active and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            _logger.info("profiler: tracing %d steps to %s", self.num_steps, self.trace_dir)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()
        try:
            yield active
        finally:
            if self._profiler is not None and step == self.start + self.num_steps - 1:
                self._profiler.__exit__(None, None, None)
                os.makedirs(self.trace_dir, exist_ok=True)
                path = os.path.join(self.trace_dir, f"trace_steps_{self.start}.json")
                self._profiler.export_chrome_trace(path)
                self._profiler = None
                _logger.info("profiler: trace written to %s", path)
