"""PointNet++ sampling and grouping with fixed output shapes
(deepsir_tpu/ops/pointnet.py): farthest-point sampling, the ball query and
their composition.

Farthest-point sampling is S dependent steps; each is a few tensor ops on
the cloud's device with no host read, so on the card the loop only queues
launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from deepsir_tpu_torch.ops.distance import square_distance
from deepsir_tpu_torch.ops.gather import gather_neighbour, gather_points

index_points = gather_points


def farthest_point_sample(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Iterative farthest-point sampling: xyz (..., N, C) -> (..., S) int64.

    Starts at row 0; each next sample is the row farthest from those taken
    (squared distance over all C channels), the first such row on ties.
    """
    *batch, n, c = xyz.shape
    pts = xyz.reshape(-1, n, c)
    rows = torch.arange(pts.shape[0], device=xyz.device)
    dist = torch.full(pts.shape[:2], float("inf"), dtype=xyz.dtype, device=xyz.device)
    idx = torch.zeros(pts.shape[0], num_samples, dtype=torch.int64, device=xyz.device)
    last = torch.zeros_like(rows)
    for i in range(1, num_samples):
        d = torch.sum((pts - pts[rows, last][:, None, :]) ** 2, dim=-1)
        dist = torch.minimum(dist, d)
        last = torch.argmax(dist, dim=-1)
        idx[:, i] = last
    return idx.reshape(*batch, num_samples)


def query_ball_point(radius: float, num_neighbours: int, xyz: torch.Tensor,
                     centers: torch.Tensor) -> torch.Tensor:
    """Fixed-capacity ball query: xyz (..., N, 3), centers (..., S, 3) ->
    (..., S, K) int64, the up to K nearest points strictly within `radius`
    of each center, nearest first (a stable sort: ties in row order); slots
    past the count repeat the first of them (the reference's group_first
    fill), or row 0 when the ball is empty."""
    d = square_distance(centers, xyz)                                  # (..., S, N)
    key = torch.where(d < radius ** 2, d, torch.full_like(d, float("inf")))
    idx = torch.argsort(key, dim=-1, stable=True)[..., :num_neighbours]
    kth = torch.gather(key, -1, idx)
    return torch.where(torch.isinf(kth), idx[..., :1], idx)


def sample_and_group(num_samples: int, radius: float, num_neighbours: int,
                     xyz: torch.Tensor, features: Optional[torch.Tensor] = None):
    """Farthest-point centers and their ball groups, recentred.

    xyz (..., N, 3), features (..., N, C) or None -> (new_xyz (..., S, 3),
    grouped (..., S, K, 3 [+ C])): each group's coordinates minus its center,
    then its features.
    """
    new_xyz = gather_points(xyz, farthest_point_sample(xyz, num_samples))
    idx = query_ball_point(radius, num_neighbours, xyz, new_xyz)
    grouped = gather_neighbour(xyz, idx) - new_xyz[..., :, None, :]
    if features is not None:
        grouped = torch.cat([grouped, gather_neighbour(features, idx)], dim=-1)
    return new_xyz, grouped
