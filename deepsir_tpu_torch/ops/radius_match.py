"""Ground-truth correspondences by radius search on the host, for the data
layer's match lists (deepsir_tpu/ops/radius_match.py: radius_matches_np,
its scipy path, and pad_matches).

The JAX package hands `radius_matches_np` to its optional C++ library when
that is built; the pairs it emits are the same set in another order. The
port runs the scipy version always.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from deepsir_tpu_torch.math import se3_np


def radius_matches_np(source_xyz: np.ndarray, target_xyz: np.ndarray,
                      trans: np.ndarray, radius: float) -> np.ndarray:
    """All pairs (i, j) with |trans * src_i - tgt_j| < radius, as (P, 2)
    int32, by source point and then in the tree's order."""
    src_t = se3_np.transform(trans, source_xyz[:, :3])
    neighbours = cKDTree(target_xyz[:, :3]).query_ball_point(src_t, r=radius)
    pairs = [(i, j) for i, idx in enumerate(neighbours) for j in idx]
    if not pairs:
        return np.zeros((0, 2), dtype=np.int32)
    return np.asarray(pairs, dtype=np.int32)


def pad_matches(matches: np.ndarray, capacity: int) -> tuple[np.ndarray, int]:
    """A (P, 2) match list cut or padded with (-1, -1) rows to (capacity, 2),
    and the number of real rows."""
    num = min(len(matches), capacity)
    out = np.full((capacity, 2), -1, dtype=np.int32)
    if num:
        out[:num] = matches[:num]
    return out, num
