"""Device-input double buffering (deepsir_tpu/utils/prefetch.py).

`device_prefetch` moves the host-to-device copy of batch i+1 to a
background thread, so that it runs while the device computes batch i. On a
CUDA device the thread copies from pinned host memory, `non_blocking`, on a
side stream of its own; each batch carries an event recorded after its
copy, and the consumer's stream waits on that event before the batch is
handed out, so the kernels that read it (launched on the current stream)
run after the copy. Each tensor of the batch is marked with `record_stream`
for the consumer's stream, so the allocator does not reuse its memory while
the consumer's work may still read it. On the CPU a copy is `torch.from_numpy`.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch


def to_device(x: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`: on a CUDA device through pinned memory,
    `non_blocking` on the calling thread's current stream; on the CPU the
    array itself, as a tensor."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _transfer(batch: Any, device) -> Any:
    """Every array leaf of a batch dict on `device`; the rest as it is."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) if isinstance(v, np.ndarray) else v
                for k, v in batch.items()}
    return to_device(batch, device)


def _tensors(value: Any) -> Iterator[torch.Tensor]:
    """The tensors of a batch, through dicts, lists and tuples."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def device_prefetch(iterable: Iterable, size: int = 2, transfer=None,
                    device="cuda") -> Iterator:
    """Iterate `iterable`, each batch moved to `device` by a background
    thread `size` batches ahead of the consumer.

    `transfer(batch)` runs on that thread (default: every array leaf of a
    dict to the device with `to_device`); on a CUDA device it runs on the
    thread's side stream. Exceptions raised by the source iterator or the
    transfer re-raise at the consumer's next(). The queue is bounded, so at
    most `size` batches wait on the device beyond the one being consumed; a
    consumer that abandons the generator releases the thread.
    """
    device = torch.device(device)
    if transfer is None:
        def transfer(batch):
            return _transfer(batch, device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer has gone, so the
        # thread never blocks forever holding device buffers
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def staged(item):
        if side is None:
            return _Ok(transfer(item), None)
        with torch.cuda.device(device), torch.cuda.stream(side):
            value = transfer(item)
            done = torch.cuda.Event()
            done.record(side)
        return _Ok(value, done)

    def worker():
        try:
            for item in iterable:
                if not put(staged(item)):
                    return
        except BaseException as exc:   # noqa: BLE001 — re-raised at the consumer
            put(_Err(exc))
            return
        put(sentinel)

    thread = threading.Thread(target=worker, daemon=True, name="device-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, _Err):
                raise item.exc
            if item.done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(item.done)
                for t in _tensors(item.value):
                    if t.device.type == "cuda":
                        t.record_stream(consumer)
            yield item.value
    finally:
        stop.set()


class _Ok:
    __slots__ = ("value", "done")

    def __init__(self, value, done):
        self.value = value
        self.done = done


class _Err:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc
