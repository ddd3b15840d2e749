"""Voxel-grid downsampling (deepsir_tpu/ops/voxel.py): on the host for the
data layer's readers (`voxel_downsample_np`, its numpy path), and on the
tensors' device with a fixed capacity (`voxel_downsample`).

The JAX package hands the unlabelled host case to its optional C++ library
when that is built; its result agrees with this one in value, not in bits
or row order. The port runs the numpy version always.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def voxel_downsample_np(points: np.ndarray, voxel_size: float,
                        label_column: int | None = None) -> np.ndarray:
    """The mean of every column over the points of each occupied voxel.

    points (N, C) with xyz first -> (V, C), one row per voxel in the order
    of the voxel keys. The integer class column `label_column`, if given,
    takes each voxel's most frequent class instead of the mean (ties to the
    higher class id).
    """
    if len(points) == 0:
        return points
    coords = np.floor(points[:, :3].astype(np.float64) / voxel_size).astype(np.int64)
    coords -= coords.min(axis=0)
    dims = coords.max(axis=0) + 1
    keys = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    uniq, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    out = np.zeros((len(uniq), points.shape[1]), dtype=np.float64)
    np.add.at(out, inv, points)
    out /= counts[:, None]
    if label_column is not None:
        lab = points[:, label_column].astype(np.int64)
        base = int(lab.max()) + 1
        comb, cnt = np.unique(inv * base + lab, return_counts=True)
        vox, cls = comb // base, comb % base
        # per voxel the most frequent class; unique's ascending order puts
        # the higher class of a tie last
        order = np.lexsort((cls, cnt, vox))
        vox_o, cls_o = vox[order], cls[order]
        last = np.r_[vox_o[1:] != vox_o[:-1], True]
        out[vox_o[last], label_column] = cls_o[last]
    return out.astype(points.dtype)


def voxel_downsample(points: torch.Tensor, voxel_size: float, capacity: int,
                     valid_mask: Optional[torch.Tensor] = None):
    """The mean of every column over the points of each occupied voxel, in
    fixed shapes.

    points (N, C) with xyz first; valid_mask (N,) bool marks the real rows
    (all if None). Voxels are ordered by (x, y, z) cell: two stable sorts,
    the (y, z) key and then the x key, so no key needs the product of all
    three extents. Voxels past `capacity` are dropped (size it generously).
    Returns (out (capacity, C), mask (capacity,) bool). The sums are a
    scatter-add, which on a CUDA tensor adds in no fixed order: means agree
    with the host's to rounding, slots and masks exactly.
    """
    n, c = points.shape
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=points.device)
    big = torch.iinfo(torch.int64).max
    coords = torch.floor(points[:, :3] / voxel_size).to(torch.int64)
    coords = coords - torch.where(valid_mask[:, None], coords, big).amin(dim=0)
    dims = torch.where(valid_mask[:, None], coords, -1).amax(dim=0) + 1
    key_minor = coords[:, 1] * dims[2] + coords[:, 2]
    key_major = torch.where(valid_mask, coords[:, 0], big)
    order = torch.argsort(key_minor, stable=True)
    order = order[torch.argsort(key_major[order], stable=True)]
    coords_s, pts_s, valid_s = coords[order], points[order], valid_mask[order]

    is_new = torch.ones(n, dtype=torch.bool, device=points.device)
    is_new[1:] = torch.any(coords_s[1:] != coords_s[:-1], dim=1)
    is_new = is_new & valid_s
    slot = torch.cumsum(is_new, dim=0) - 1
    # padding rows and voxels past the capacity go to the dump slot
    slot = torch.where(valid_s & (slot < capacity), slot, capacity)
    sums = torch.zeros(capacity + 1, c, dtype=points.dtype,
                       device=points.device).index_add_(0, slot, pts_s)
    cnts = torch.zeros(capacity + 1, dtype=torch.int64,
                       device=points.device).index_add_(0, slot, valid_s.to(torch.int64))
    return sums[:capacity] / cnts[:capacity, None].clamp_min(1), cnts[:capacity] > 0
