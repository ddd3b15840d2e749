"""Fixed-iteration point-to-point ICP on the device (deepsir_tpu/ops/icp.py::icp).

Each iteration moves the source by the current pose, finds every moved
point's nearest target point with `ops/knn.py` (kernel K1 at k=1 on the
card, its plain version on the CPU), weights the pairs closer than
max_corr_dist by 1 and the rest by 0 (static shapes), solves the weighted
Kabsch and composes. Batched over the leading axis.

`icp_np` is the data layer's ICP on the host (deepsir_tpu/ops/icp.py::icp_np,
its scipy path), which refines the KITTI and Oxford ground-truth poses. The
JAX package hands it to its optional C++ library when that is built, which
agrees in value, not in bits; the port runs the scipy version always.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from deepsir_tpu_torch.math import se3, se3_np
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


def _kabsch_np(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """The unweighted rigid fit tgt ~= T src of matched rows, 4x4 float64."""
    cs = src.mean(axis=0)
    ct = tgt.mean(axis=0)
    u, _, vt = np.linalg.svd((src - cs).T @ (tgt - ct))
    flip = np.diag([1.0, 1.0, np.sign(np.linalg.det(vt.T @ u.T))])
    rot = vt.T @ flip @ u.T
    out = np.eye(4)
    out[:3, :3] = rot
    out[:3, 3] = ct - rot @ cs
    return out


def icp_np(src: np.ndarray, tgt: np.ndarray, max_corr_dist: float,
           init: np.ndarray | None = None, max_iter: int = 200,
           tol: float = 1e-7) -> np.ndarray:
    """Point-to-point ICP on the host, the 4x4 transform src -> tgt: pairs
    each moved source point with its nearest target within max_corr_dist,
    until fewer than 3 pair, the rmse moves by less than tol, or max_iter."""
    transform = np.eye(4) if init is None else se3_np.to_4x4(np.asarray(init, dtype=np.float64))
    tree = cKDTree(tgt[:, :3])
    prev_rmse = np.inf
    for _ in range(max_iter):
        src_t = se3_np.transform(transform, src[:, :3])
        dist, idx = tree.query(src_t, distance_upper_bound=max_corr_dist)
        mask = np.isfinite(dist)
        if mask.sum() < 3:
            break
        transform = _kabsch_np(src_t[mask], tgt[idx[mask], :3]) @ transform
        rmse = float(np.sqrt(np.mean(dist[mask] ** 2)))
        if abs(prev_rmse - rmse) < tol:
            break
        prev_rmse = rmse
    return transform
