"""Step tracing, named spans and anomaly detection
(deepsir_tpu/utils/profiling.py).

`StepTracer.maybe_trace(step)` traces steps [start, start + num_steps)
with `torch.profiler` (CPU and, on a card, CUDA activity) when
DEEPSIR_PROFILE names a directory, and writes a Chrome trace there;
otherwise it does nothing. `close()` writes the trace of a run that ended
inside the window. `enable_debug_mode` turns on autograd's anomaly
detection, which names the operation whose backward produced a NaN.

`span(name)` marks where each layer's work happens. While a profiler
runs (StepTracer's, or any other `torch.profiler` session) it opens a host
range of that name in the trace; otherwise it is one shared no-op context.
The range is recorded as a host operation (the profiler's `cpu_op`
category), so that a trace's readers find it beside the operators it holds.
A device event belongs to a span when the host call that launched it ran
inside the span; the backward's kernels, launched from autograd's own
thread while `loss.backward()` runs, fall in `deepsir.train.backward`. A
span synchronises nothing, reads no device value and changes nothing that is
computed. The spans (`SPANS`), from the entry point down:

- `deepsir.h2d`: `training.device_batch`'s copies of the host arrays to
  the device (two ranges a batch: the clouds, masks and indices before the
  pyramids, `transform_gt` after them).
- `deepsir.pyramid`: one cloud's index pyramid (`ops.pyramid.
  build_cloud_pyramid`: the K1 or K4 searches and the sampling), also the
  strided pyramid that `refine_stride` builds inside the forward.
- `deepsir.backbone`: the RandLA feature extractor over both clouds
  (`Network.backbone_pair`).
- `deepsir.randla.encoder`, `.decoder`, `.head`: inside each forward of a
  RandLA net (`models/randla.py`: the backbone's, and the inlier net's in
  the loop), never inside one another: `mlp_pre`, the four blocks and
  their pooling; `mlp_mid` and the decoder's stages; the head (`mlp_out`,
  dropout, `fc_label`, or RandLA-Net's `fc1`, `fc2`, dropout, `fc`).
- `deepsir.score`: keypoint scores of both clouds (`Network.score_pair`).
- `deepsir.descriptor`: the aggregated descriptors computed once a
  forward: under align the reference descriptor and `mlp_feat` of the
  source features, outside the loop; under feat both clouds' descriptors and
  the `num_sub` cut.
- `deepsir.inlier_cache`: the inlier RandLA's LocSE projections of the
  source pyramid (`RandLA.pos_cache`), computed once before the loop (and
  once more for the strided pyramid of `refine_stride`).
- `deepsir.loop.aggregate`, `.search`, `.inputs`, `.inlier`, `.gate`,
  `.pose`: once per registration iteration, in this order: the moving source
  descriptor (`mlp_att`, `mlp_proj`); the nearest-descriptor search (K2, K3
  or the `matcher` hook); the gathers and the `dist` / `recip` channels of
  the inlier net's input; the inlier RandLA; the sigmoid, clip, mask and
  mutual gate of the weights; the weighted Kabsch solve and the pose
  updates.
- `deepsir.train.forward`: the pipeline's training forward
  (`training.compute_loss`: `forward_pair` or `forward_align(train=True)`).
- `deepsir.train.loss`: the pipeline's loss (`det_des_loss`,
  `semantic_loss` or `scan_alignment_loss`).
- `deepsir.train.backward`: `loss.backward()`, and the data-parallel
  reductions of the gradients and the loss terms when there are any.
- `deepsir.train.guard`: the skip guard's finiteness checks and its one
  host read.
- `deepsir.train.optimizer`: Adam's update (absent from a skipped step).

Outside every span in a forward: `se3.identity` and the stacking of the
iterations' outputs.
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

import torch

_logger = logging.getLogger("profiling")

SPANS = ("deepsir.h2d", "deepsir.pyramid", "deepsir.backbone", "deepsir.randla.encoder",
         "deepsir.randla.decoder", "deepsir.randla.head", "deepsir.score",
         "deepsir.descriptor", "deepsir.inlier_cache", "deepsir.loop.aggregate",
         "deepsir.loop.search", "deepsir.loop.inputs", "deepsir.loop.inlier",
         "deepsir.loop.gate", "deepsir.loop.pose", "deepsir.train.forward",
         "deepsir.train.loss", "deepsir.train.backward", "deepsir.train.guard",
         "deepsir.train.optimizer")

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
# a host range that the profiler records as an operator (cpu_op), where
# record_function's is a user annotation
_RANGE = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range called `name` while a profiler runs, else a shared
    no-op context (module docstring). Asked at every entry: a profiler may
    start or stop between two calls."""
    return _RANGE(name) if _profiling() else _OFF


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
            if step == self.start + self.num_steps - 1:
                self.close()

    def close(self) -> None:
        """Stop a trace still open and write it: the run ended inside the
        window. Nothing to do otherwise."""
        if self._profiler is None:
            return
        self._profiler.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, f"trace_steps_{self.start}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        _logger.info("profiler: trace written to %s", path)
