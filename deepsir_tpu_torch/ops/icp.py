"""Fixed-iteration point-to-point ICP on the device (deepsir_tpu/ops/icp.py::icp).

Each iteration moves the source by the current pose, finds every moved
point's nearest target point with `ops/knn.py` (kernel K1 at k=1 on the
card, its plain version on the CPU), weights the pairs closer than
max_corr_dist by 1 and the rest by 0 (static shapes), solves the weighted
Kabsch and composes. Batched over the leading axis. The host ICP of the data
layer (`icp_np`) is not here.
"""
from __future__ import annotations

import torch

from deepsir_tpu_torch.math import se3
from deepsir_tpu_torch.ops.gather import gather_points
from deepsir_tpu_torch.ops.knn import knn
from deepsir_tpu_torch.ops.svd3 import weighted_kabsch


@torch.no_grad()
def icp(src: torch.Tensor, tgt: torch.Tensor, max_corr_dist: float, init: torch.Tensor,
        num_iter: int = 30) -> torch.Tensor:
    """src (B, N, 3), tgt (B, M, 3) float32 -> the transform src -> tgt (B, 3, 4),
    starting from `init` (B, 3, 4)."""
    src, tgt = src.contiguous(), tgt.contiguous()
    pose = init
    # the gate compares with the float32 square of the float32 distance, as
    # JAX squares its traced float32 argument
    max_sq = torch.tensor(max_corr_dist, dtype=torch.float32, device=src.device) ** 2
    for _ in range(num_iter):
        moved = se3.transform(pose, src)
        idx, sq = knn(moved, tgt, 1)
        w = (sq[..., 0] < max_sq).to(src.dtype)
        delta, _ = weighted_kabsch(moved, gather_points(tgt, idx[..., 0]), w)
        pose = se3.concatenate(delta, pose)
    return pose
