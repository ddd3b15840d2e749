"""The training step replayed as CUDA graphs cut at the program's spans
(`training.train_step` drives it).

- When graphs engage (`eager_reason`): the parameters are on a CUDA
  device, no data-parallel mesh is given (its NCCL calls stay eager) and
  autograd's anomaly detection is off. Nothing else chooses: there is no
  option, only `train_step`'s internal `graphs=False`, for tests.
- What a capture is kept for (`captures`, `step_key`): per model (held
  weakly), per optimizer, generator, pipeline, the run's model and loss
  configs, the batch's key set, shapes and dtypes, and the TF32 switches;
  and only while every parameter and buffer keeps its storage and
  `requires_grad` (`param_key`). `load_state_dict` copies in place and
  keeps them; a parameter whose storage was replaced (`.to`,
  `p.data = ...`) drops every capture of its model.
- When it is made: the first step on a key runs eagerly (the warm-up:
  cuBLAS handles, autograd's streams, Adam's state), the second is captured
  and then replayed, every later step is a replay.
- What a capture holds (`Capture`): the step from the pyramids through the
  skip guard's finiteness checks, as a sequence of graphs in one memory
  pool, cut at every span entry and exit (`utils.profiling.cut_at_spans`).
  Each graph (`Segment`) keeps the spans it was captured in and the launch
  counts its capture added to the kernel wrappers' counters (`COUNTERS`).
  A graph with no node (two span boundaries with no work between them) is
  dropped.
- A replay (`replay`) launches the graphs in capture order, each inside the
  spans it was captured in (their profiler ranges reopened around its
  launch while a profiler runs), and adds the counts back.
- What stays eager: the copies of the host batch into the capture's static
  input buffers, the guard's one host read, the learning rate and Adam's
  update (`training.py`).
- Dropout: the step's generator is registered with every graph, so each
  replay draws fresh masks with the values the eager step draws, in the
  same order. A torch without `CUDAGraph.register_generator_state` runs
  the step eagerly (reason "generator").
"""
from __future__ import annotations

import contextlib
import gc
import threading
import warnings
import weakref
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from deepsir_tpu_torch.ops.cuda_circle import circle_rows
from deepsir_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_windowed
from deepsir_tpu_torch.ops.cuda_match import match_argmin, match_argmin_bidirectional
from deepsir_tpu_torch.utils import profiling

# why a step ran eagerly, in the order they are asked: train_step was asked
# to (graphs=False); a data-parallel mesh; anomaly detection; the parameters
# are not on a CUDA device; no graph-safe generator; the first step on its key
REASONS = ("asked", "mesh", "anomaly", "device", "generator", "warmup")

# the kernel wrappers' launch counters: (function, attribute)
COUNTERS = ((knn_topk, "launches"), (knn_topk_windowed, "launches"),
            (match_argmin, "launches"), (match_argmin, "launches_lp"),
            (match_argmin_bidirectional, "launches"),
            (match_argmin_bidirectional, "launches_lp"), (circle_rows, "launches"))

WARM = "warm"               # what `captures` holds for a key whose warm-up ran
_EMPTY = "The CUDA Graph is empty"       # torch's warning at the end of an empty capture


def eager_reason(device: torch.device, mesh=None, generator=None,
                 graphs: bool = True) -> Optional[str]:
    """Why a step on `device` runs eagerly (one of REASONS), or None where
    graphs engage."""
    if not graphs:
        return "asked"
    if mesh is not None:
        return "mesh"
    if torch.is_anomaly_enabled():
        return "anomaly"
    if device.type != "cuda":
        return "device"
    if generator is not None and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        return "generator"
    return None


def step_key(optimizer, generator, cfgs, arrays: Dict[str, Any]) -> tuple:
    """What a step's capture is kept for, besides its model (module doc),
    and the TF32 switches, which choose the kernels it captures."""
    batch = tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in arrays.items()))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    return optimizer, generator, cfgs.pipeline, cfgs.model, cfgs.loss, batch, tf32


def param_key(model: torch.nn.Module) -> tuple:
    """The storage and `requires_grad` of every parameter and buffer."""
    return (tuple((p.data_ptr(), p.requires_grad) for p in model.parameters())
            + tuple(b.data_ptr() for b in model.buffers()))


class _Captures(NamedTuple):
    params: tuple
    steps: Dict[tuple, Any]


_MODELS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def captures(model: torch.nn.Module) -> Dict[tuple, Any]:
    """`model`'s captures by `step_key`: a StepGraph, or WARM where only the
    warm-up ran. Emptied when a parameter's or buffer's storage or
    `requires_grad` changed since they were made."""
    params = param_key(model)
    held = _MODELS.get(model)
    if held is None or held.params != params:
        held = _MODELS[model] = _Captures(params, {})
    return held.steps


class Segment(NamedTuple):
    graph: Any                              # a torch.cuda.CUDAGraph
    spans: Tuple[Tuple[str, int], ...]      # the spans open around it: (name, entry number)
    counts: Tuple[int, ...]                 # what its capture added to each of COUNTERS


class StepGraph(NamedTuple):
    """A captured step: its static input buffers by array key, its graphs,
    the guard's device flag, the static outputs (compute_loss's aux,
    detached) and the trained parameters with their static grads."""
    inputs: Dict[str, torch.Tensor]
    segments: Tuple[Segment, ...]
    ok: torch.Tensor
    aux: Dict[str, Any]
    named: Tuple[Tuple[str, torch.nn.Parameter], ...]
    grads: Tuple[Optional[torch.Tensor], ...]


def _read(counters) -> Tuple[int, ...]:
    return tuple(getattr(fn, attr) for fn, attr in counters)


def _add(counters, counts: Sequence[int]) -> None:
    for (fn, attr), n in zip(counters, counts):
        if n:
            setattr(fn, attr, getattr(fn, attr) + n)


class Capture:
    """Capture the device work launched inside `with Capture(...)` as a
    sequence of graphs: one begins on entry and at every span boundary of
    this thread (`boundary`), the one before it ends there; `finish` ends
    the last. `new_graph()` makes a graph (torch.cuda.CUDAGraph on the card),
    `pool` is the memory pool they share, `generator` is registered with
    each. The capture runs on the caller's current stream, which must not
    be the default one (`capturing` sets that up)."""

    def __init__(self, new_graph: Callable[[], Any], pool=None,
                 generator: Optional[torch.Generator] = None, counters=COUNTERS):
        self.thread = threading.get_ident()
        self.segments: list = []
        self._new_graph, self._pool, self._generator = new_graph, pool, generator
        self._counters = counters
        self._open: list = []          # spans open now: (name, entry number)
        self._entries = 0
        self._graph, self._start = None, ()
        self._empty: list = []
        self._done = False
        self._cut = profiling.cut_at_spans(self)

    def __enter__(self) -> "Capture":
        self._cut.__enter__()
        try:
            self._begin()
        except BaseException:
            self._cut.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc) -> None:
        try:
            if not self._done:
                self._done = True
                if exc[0] is None:
                    self._end()
                elif self._graph is not None:   # end the broken capture, keep its error
                    with contextlib.suppress(Exception):
                        self._graph.capture_end()
        finally:
            self._cut.__exit__(*exc)

    def boundary(self, name: str, entering: bool) -> None:
        """A span called `name` is entered or left: end this graph and
        begin the next, inside the spans open from now on."""
        if self._done:
            return
        self._end()
        if entering:
            self._entries += 1
            self._open.append((name, self._entries))
        else:
            if not self._open or self._open[-1][0] != name:
                raise RuntimeError(f"span {name} left but not entered during the capture")
            self._open.pop()
        self._begin()

    def finish(self) -> None:
        """End the last graph; later span boundaries cut nothing."""
        if not self._done:
            self._done = True
            self._end()

    def _begin(self) -> None:
        graph = self._new_graph()
        if self._generator is not None:
            graph.register_generator_state(self._generator)
        self._start = _read(self._counters)
        graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
        self._graph = graph

    def _end(self) -> None:
        graph, self._graph = self._graph, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in caught:
            if str(w.message).startswith(_EMPTY):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        counts = tuple(b - a for a, b in zip(self._start, _read(self._counters)))
        if empty and any(counts):
            raise RuntimeError(f"an empty graph counted kernel launches {counts}")
        if empty:
            # held until the capture goes: a graph released during the capture
            # would drop its share of the pool that the next graph joins
            self._empty.append(graph)
        else:
            self.segments.append(Segment(graph, tuple(self._open), counts))


@contextlib.contextmanager
def capturing(device: torch.device, generator: Optional[torch.Generator]) -> Iterator[Capture]:
    """A Capture on a side stream of `device`, with a fresh memory pool, set
    up as `torch.cuda.graph` sets up its capture."""
    stream = torch.cuda.Stream(device)
    torch.cuda.synchronize(device)
    gc.collect()
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        with Capture(torch.cuda.CUDAGraph, torch.cuda.graph_pool_handle(), generator) as cap:
            yield cap
    current.wait_stream(stream)


def _reopen(ranges: list, spans: Tuple[Tuple[str, int], ...]) -> None:
    """Close the open ranges down to what `spans` shares with them, then
    open the rest of `spans`: the nesting of the capture, rebuilt."""
    keep = 0
    while keep < min(len(ranges), len(spans)) and ranges[keep][0] == spans[keep]:
        keep += 1
    while len(ranges) > keep:
        ranges.pop()[1].__exit__(None, None, None)
    for entry in spans[keep:]:
        rng = profiling.span(entry[0])
        rng.__enter__()
        ranges.append((entry, rng))


@contextlib.contextmanager
def replay(segments: Sequence[Segment], counters=COUNTERS, count: bool = True
           ) -> Iterator[None]:
    """Launch `segments` in order, each inside the spans it was captured in
    while a profiler runs, and (with `count`) add their launch counts to
    the counters. The last segment's spans stay open until the block ends,
    so that the host work after the replay (the guard's read) falls in them."""
    ranges: list = []
    traced = profiling.profiler_running()
    try:
        for seg in segments:
            if traced:
                _reopen(ranges, seg.spans)
            seg.graph.replay()
            if count:
                _add(counters, seg.counts)
        yield
    finally:
        while ranges:
            ranges.pop()[1].__exit__(None, None, None)

