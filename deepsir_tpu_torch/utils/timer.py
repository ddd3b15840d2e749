"""Wall-clock timing with running statistics (deepsir_tpu/utils/timer.py)."""
from __future__ import annotations

import time

import numpy as np


class AverageMeter:
    """Running mean and variance of scalar observations."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0
        self.var = 0.0

    def update(self, val, n: int = 1):
        if isinstance(val, np.ndarray):
            n = val.size
            val = float(val.mean())
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += val ** 2 * n
        self.var = self.sq_sum / self.count - self.avg ** 2


class Timer(AverageMeter):
    """tic/toc on the host clock with a running average. The caller fences
    the device before toc where the device's work is to be counted."""

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.update(self.diff)
        return self.avg if average else self.diff
