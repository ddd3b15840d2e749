"""Morton (Z-order) sort of point clouds, on the host (numpy only).

The port's own copy of deepsir_tpu/ops/morton.py::morton_code_np and
morton_order_np. Under `pyramid_order="morton"` the caller sorts every cloud
with `morton_order_np` before `training.device_batch`: the pyramid then
samples every r-th point and restricts each level's KNN to a curve-rank
window (ops/window.py), which is only valid for curve-sorted clouds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

_BITS = 21      # bits per axis: the 63-bit interleave fills an int64 code


def _spread3_np(x: np.ndarray) -> np.ndarray:
    """Interleave zeros: bit i of x moves to bit 3i (x < 2^21), int64."""
    x = x.astype(np.int64) & ((1 << _BITS) - 1)
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def morton_code_np(xyz: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-point int64 Morton code of one cloud (N, >=3).

    Coordinates are scaled into the 21-bit grid by the cloud's own bounding
    box (of its valid rows); invalid rows get the largest code.
    """
    pts = np.asarray(xyz, np.float64)[..., :3]
    ref = pts
    if valid is not None:
        vm = np.asarray(valid, bool)
        ref = pts[vm] if vm.any() else pts
    lo = ref.min(axis=0)
    span = ref.max(axis=0) - lo
    scale = (float(1 << _BITS) - 1.0) / np.maximum(span, 1e-12)
    q = np.clip((pts - lo) * scale, 0, (1 << _BITS) - 1).astype(np.int64)
    code = (_spread3_np(q[:, 0]) | (_spread3_np(q[:, 1]) << 1)
            | (_spread3_np(q[:, 2]) << 2))
    if valid is not None:
        code = np.where(np.asarray(valid, bool), code, np.int64(2**62))
    return code


def morton_order_np(xyz: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Stable permutation sorting one cloud's points by Morton code, invalid
    rows last."""
    return np.argsort(morton_code_np(xyz, valid), kind="stable")


def sort_clouds(points: np.ndarray) -> np.ndarray:
    """Each cloud of a (B, N, C) batch with its rows in Morton order."""
    return np.stack([c[morton_order_np(c[:, :3])] for c in points])
