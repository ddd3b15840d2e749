"""The port's device-input double buffering (utils/prefetch.py), the
cases of tests/test_prefetch.py on the CPU: order and transfer, a custom
transfer, a source exception, an empty source and an abandoned consumer.
The CUDA side stream and its events run only on the card (chip_smoke.py
phase "eval" feeds every inference sweep through it)."""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import threading
import time

import numpy as np
import pytest
import torch

from deepsir_tpu_torch.utils.prefetch import device_prefetch, to_device


def test_order_and_transfer():
    batches = [{"x": np.full((2, 2), i, np.float32), "meta": [i]} for i in range(7)]
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        assert b["meta"] == [i]                     # non-arrays pass through
        np.testing.assert_array_equal(b["x"].numpy(), np.full((2, 2), i))


def test_custom_transfer():
    got = list(device_prefetch(range(4), transfer=lambda i: i * 10, device="cpu"))
    assert got == [0, 10, 20, 30]


@pytest.mark.parametrize("where", ["source", "transfer"])
def test_exception_propagates(where):
    def gen():
        yield {"x": np.zeros(1)}
        if where == "source":
            raise RuntimeError("boom")
        yield {"x": None}

    def transfer(batch):
        if batch["x"] is None:
            raise RuntimeError("boom")
        return {"x": to_device(batch["x"], "cpu")}

    it = device_prefetch(gen(), transfer=transfer, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_empty_source():
    assert list(device_prefetch([], device="cpu")) == []


def test_abandoned_consumer_releases_worker():
    started = threading.Event()

    def gen():
        for i in range(100):
            started.set()
            yield i

    it = device_prefetch(gen(), size=1, transfer=lambda i: i, device="cpu")
    assert next(it) == 0
    started.wait(2)
    it.close()                                  # abandon mid-stream

    def worker_alive():
        return any(t.name == "device-prefetch" and t.is_alive()
                   for t in threading.enumerate())

    deadline = time.time() + 3
    while time.time() < deadline and worker_alive():
        time.sleep(0.05)
    assert not worker_alive()


def test_to_device_on_the_cpu_shares_the_array():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = to_device(x, "cpu")
    assert t.dtype == torch.float32 and t.data_ptr() == x.ctypes.data
