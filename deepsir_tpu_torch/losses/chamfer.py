"""Chamfer-distance losses (deepsir_tpu/losses/chamfer.py), channel-last.

The plain forms reduce the distance matrix tile by tile and never build it
whole (`ops.distance.nearest_square_distance`), with the gradient of each
row's minimum, as the JAX package's tiled minimum has one. The
score-weighted form needs each point's nearest partner's score, so it
builds the full (..., M, N) matrix: moderate sizes only. `compute_loss`
does not call them, as the JAX package's does not.

Each distance is sqrt(max(d, 0) + 1e-12) of the float32 norm expansion d.
The JAX package leaves out the max, so where rounding puts d below -1e-12
(nearly coincident points far from the origin, as in a registered pair)
its loss is NaN; wherever JAX's is finite the two agree.
"""
from __future__ import annotations

from typing import Optional

import torch

from deepsir_tpu_torch.ops.distance import nearest_square_distance, square_distance

_EPS = 1e-12


def _dist(sq: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(sq, 0.0) + _EPS)


def _mean_nearest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(_dist(nearest_square_distance(a, b)))


def single_side_chamfer(pc_src: torch.Tensor, pc_dst: torch.Tensor) -> torch.Tensor:
    """mean_i min_j |src_i - dst_j|: pc_src (..., M, 3), pc_dst (..., N, 3) ->
    a scalar."""
    return _mean_nearest(pc_src, pc_dst)


def chamfer_loss(pc_src: torch.Tensor, pc_dst: torch.Tensor,
                 sigma_src: Optional[torch.Tensor] = None,
                 sigma_dst: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric chamfer distance: pc_src (..., M, 3), pc_dst (..., N, 3) ->
    a scalar. With keypoint scores sigma_src (..., M) and sigma_dst (..., N)
    each nearest distance is weighted by the mean of its two points' scores
    (the partner is the first nearest, as argmin picks it)."""
    if sigma_src is None or sigma_dst is None:
        return _mean_nearest(pc_src, pc_dst) + _mean_nearest(pc_dst, pc_src)
    d = _dist(square_distance(pc_src, pc_dst))                           # (..., M, N)
    fwd_min, fwd_arg = torch.min(d, dim=-1)
    fwd = torch.mean(fwd_min * (sigma_src + torch.gather(sigma_dst, -1, fwd_arg)) * 0.5)
    bwd_min, bwd_arg = torch.min(d, dim=-2)
    bwd = torch.mean(bwd_min * (sigma_dst + torch.gather(sigma_src, -1, bwd_arg)) * 0.5)
    return fwd + bwd
