"""Space-filling-curve codes and orders of point clouds
(deepsir_tpu/ops/morton.py).

On the host (numpy) the port's own copy of `morton_code_np`,
`morton_order_np`, `hilbert_code_np` and `hilbert_order_np`. Under
`pyramid_order="morton"` the caller sorts every cloud with `morton_order_np`
before `training.device_batch`: the pyramid then samples every r-th point
and restricts each level's KNN to a curve-rank window (ops/window.py), which
is only valid for curve-sorted clouds. On the tensors' device `morton_code`,
the JAX package's int32 code of 10 bits per axis.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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


_HILBERT_BITS = 16


def hilbert_code_np(xyz: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-point int64 Hilbert index of one cloud (N, >=3), 16 bits per axis,
    scaled by the bounding box as `morton_code_np`; invalid rows get the
    largest code. Skilling's transpose algorithm, vectorised over points:
    adjacent curve ranks are always adjacent cells."""
    bits = _HILBERT_BITS
    pts = np.asarray(xyz, np.float64)[..., :3]
    ref = pts
    if valid is not None:
        vm = np.asarray(valid, bool)
        ref = pts[vm] if vm.any() else pts
    lo = ref.min(axis=0)
    span = ref.max(axis=0) - lo
    scale = (float(1 << bits) - 1.0) / np.maximum(span, 1e-12)
    q = np.clip((pts - lo) * scale, 0, (1 << bits) - 1).astype(np.int64)
    x = [q[:, 0].copy(), q[:, 1].copy(), q[:, 2].copy()]

    # axes -> transpose: undo the excess work, then Gray-encode
    top = np.int64(1) << (bits - 1)
    b = top
    while b > 1:
        low = b - 1
        for i in range(3):
            hit = (x[i] & b) != 0
            x[0] = np.where(hit, x[0] ^ low, x[0])
            t = np.where(hit, 0, (x[0] ^ x[i]) & low)
            x[0] ^= t
            x[i] ^= t
        b >>= 1
    x[1] ^= x[0]
    x[2] ^= x[1]
    t = np.zeros_like(x[0])
    b = top
    while b > 1:
        t = np.where((x[2] & b) != 0, t ^ (b - 1), t)
        b >>= 1
    for i in range(3):
        x[i] ^= t

    # transpose -> index: interleave the bit planes, axis 0 most significant
    code = (_spread3_np(x[0]) << 2) | (_spread3_np(x[1]) << 1) | _spread3_np(x[2])
    if valid is not None:
        code = np.where(np.asarray(valid, bool), code, np.int64(2**62))
    return code


def hilbert_order_np(xyz: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Stable permutation sorting one cloud's points by Hilbert index,
    invalid rows last."""
    return np.argsort(hilbert_code_np(xyz, valid), kind="stable")


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Interleave zeros in int32: bit i of x (10 bits) moves to bit 3i."""
    x = x.to(torch.int32) & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_code(xyz: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-point int32 Morton code, 10 bits per axis: xyz (..., N, >=3) ->
    (..., N).

    Each cloud is scaled into the 1024^3 grid by the bounding box of its
    valid rows, in float32 as (p - lo) * (1023 / (hi - lo)); padding rows
    (valid False) get 2^30, above every real code.
    """
    pts = xyz[..., :3].to(torch.float32)
    if valid is not None:
        inf = torch.tensor(float("inf"), device=pts.device)
        lo = torch.where(valid[..., None], pts, inf).amin(dim=-2, keepdim=True)
        hi = torch.where(valid[..., None], pts, -inf).amax(dim=-2, keepdim=True)
    else:
        lo = pts.amin(dim=-2, keepdim=True)
        hi = pts.amax(dim=-2, keepdim=True)
    scale = 1023.0 / torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp((pts - lo) * scale, 0, 1023).to(torch.int32)
    code = _spread3(q[..., 0]) | (_spread3(q[..., 1]) << 1) | (_spread3(q[..., 2]) << 2)
    if valid is not None:
        code = torch.where(valid, code, torch.tensor(2**30, dtype=torch.int32,
                                                     device=code.device))
    return code


def sort_clouds(points: np.ndarray) -> np.ndarray:
    """Each cloud of a (B, N, C) batch with its rows in Morton order."""
    return np.stack([c[morton_order_np(c[:, :3])] for c in points])
