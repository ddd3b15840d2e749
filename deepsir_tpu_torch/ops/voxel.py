"""Voxel-grid downsampling on the host, for the data layer's readers
(deepsir_tpu/ops/voxel.py::voxel_downsample_np, its numpy path).

The JAX package hands the unlabelled case to its optional C++ library when
that is built; its result agrees with this one in value, not in bits or row
order. The port runs this numpy version always.
"""
from __future__ import annotations

import numpy as np


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
