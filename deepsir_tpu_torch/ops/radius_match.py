"""Ground-truth correspondences by radius search
(deepsir_tpu/ops/radius_match.py): on the host for the data layer's match
lists (`radius_matches_np`, its scipy path, and `pad_matches`), and on the
tensors' device with fixed shapes (`radius_matches`).

The JAX package hands `radius_matches_np` to its optional C++ library when
that is built; the pairs it emits are the same set in another order. The
port runs the scipy version always. `radius_matches` searches with
`ops.knn.knn`, which is kernel K1 on a CUDA tensor.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from deepsir_tpu_torch.math import se3, se3_np
from deepsir_tpu_torch.ops.knn import knn


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


def radius_matches(source_xyz: torch.Tensor, target_xyz: torch.Tensor, trans: torch.Tensor,
                   radius: float, k_per_point: int = 32, capacity: int = 30000):
    """All (i, j) with |trans * src_i - tgt_j| < radius, in fixed shapes.

    source_xyz (N, >=3), target_xyz (M, >=3), trans (3 or 4, 4). Each source
    point contributes its up to `k_per_point` nearest targets (exact KNN,
    ties to the lower index) that lie within the radius; the pairs are
    compacted with a stable sort, valid ones first in (i, ascending
    distance) order, and cut to `capacity`. Exact while no point has more
    than k_per_point targets in its radius and the total fits. Returns
    (pairs (capacity, 2) int64 padded with (-1, -1), num_valid, a 0-d int64
    tensor), with no host read.
    """
    n = source_xyz.shape[0]
    src_t = se3.transform(trans, source_xyz[:, :3])
    idx, sq = knn(src_t[None].contiguous(), target_xyz[None, :, :3].contiguous(), k_per_point)
    valid = (sq[0] < radius * radius).reshape(-1)
    rows = torch.arange(n, device=idx.device)[:, None].expand(n, idx.shape[-1])
    pairs = torch.stack([rows.reshape(-1), idx[0].reshape(-1)], dim=-1)     # (N * k, 2)
    order = torch.argsort((~valid).to(torch.uint8), stable=True)[:capacity]
    pairs = pairs[order]
    if pairs.shape[0] < capacity:
        pairs = torch.nn.functional.pad(pairs, (0, 0, 0, capacity - pairs.shape[0]), value=-1)
    num = torch.clamp(valid.sum(), max=capacity)
    keep = torch.arange(capacity, device=pairs.device)[:, None] < num
    return torch.where(keep, pairs, torch.full_like(pairs, -1)), num


def pad_matches(matches: np.ndarray, capacity: int) -> tuple[np.ndarray, int]:
    """A (P, 2) match list cut or padded with (-1, -1) rows to (capacity, 2),
    and the number of real rows."""
    num = min(len(matches), capacity)
    out = np.full((capacity, 2), -1, dtype=np.int32)
    if num:
        out[:num] = matches[:num]
    return out, num
