"""Scan-alignment loss: discounted per-iteration point distance, inlier BCE
and an optional pose term (deepsir_tpu/losses/align.py).

The BCE labels a predicted pair (i, pred_idx[i]) correct when
|T_gt src_i - ref_pred| < thres_radius, tested directly when the reference
points are given; otherwise by membership in padded ground-truth match
lists, hashed to int32 keys src + ref * N and located by a per-row
`searchsorted`.

Over a data-parallel `group` (the batch split across processes) each mean
over the pairs becomes this rank's share of the global batch's mean: its
rows' sum over the global pair count. The shares sum to the single-device
loss. The per-point means stay within each pair.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from deepsir_tpu_torch.config import LossConfig
from deepsir_tpu_torch.math import se3
from deepsir_tpu_torch.ops.gather import gather_points
from deepsir_tpu_torch.utils.collectives import ProcessGroup, share_mean


def correspondence_correct(pred_idx: torch.Tensor, gt_matches: torch.Tensor,
                           num_points: int) -> torch.Tensor:
    """Whether each predicted pair (i, pred_idx[i]) is a ground-truth match.

    pred_idx (B, N); gt_matches (B, M_cap, 2) (src, ref) pairs padded with
    -1 -> (B, N) bool. Padding rows hash to negative keys, which no
    prediction has.
    """
    b, n = pred_idx.shape
    if num_points * (num_points + 1) >= 2 ** 31:
        raise ValueError(f"match keys overflow int32 at {num_points} points")
    src_ids = torch.arange(n, dtype=torch.int32, device=pred_idx.device)[None, :]
    pred_keys = src_ids + pred_idx.to(torch.int32) * num_points          # (B, N)
    gm = gt_matches.to(torch.int32)
    gt_sorted = torch.sort(gm[..., 0] + gm[..., 1] * num_points, dim=-1).values
    pos = torch.searchsorted(gt_sorted, pred_keys).clamp(0, gt_sorted.shape[-1] - 1)
    return torch.gather(gt_sorted, -1, pos) == pred_keys


def scan_alignment_loss(transforms: torch.Tensor, inlier_logits: torch.Tensor,
                        pred_idx: torch.Tensor, pt_src: torch.Tensor,
                        transform_gt: torch.Tensor, gt_matches: Optional[torch.Tensor],
                        cfg: LossConfig, reduction: str = "mean",
                        pt_ref: Optional[torch.Tensor] = None,
                        mask_src: Optional[torch.Tensor] = None,
                        group: ProcessGroup = None) -> Dict[str, torch.Tensor]:
    """Loss terms over the registration iterations and their discounted total.

    transforms (iters, B, 3, 4) cumulative; inlier_logits, pred_idx
    (iters, B, N); pt_src (B, N, 3) untransformed; transform_gt (B, 3, 4);
    gt_matches (B, M_cap, 2) or None; pt_ref (B, N, 3), when given (and
    thres_radius > 0), labels the BCE geometrically; mask_src (B, N) makes
    the per-point terms average over valid rows only.

    Keys: f"{loss_type}_{i}", f"outlier_{i}", f"poseError_{i}" as their
    weights enable them, and "total", where iteration i is weighted by
    loss_discount_factor ** (iters - i - 1). reduction="none" keeps every
    entry per sample (B,). `group`: the data-parallel group under
    reduction="mean" (module docstring).
    """
    if reduction not in ("mean", "none"):
        raise ValueError(f"reduction={reduction!r}")
    if group is not None and reduction != "mean":
        raise ValueError("a data-parallel group needs reduction='mean'")
    num_iter = transforms.shape[0]
    num_points = pt_src.shape[-2]
    out: Dict[str, torch.Tensor] = {}

    def red(per_sample):
        return share_mean(per_sample, group) if reduction == "mean" else per_sample

    def point_mean(x):                                       # (B, N[, 3]) -> (B,)
        dims = tuple(range(1, x.dim()))
        if mask_src is None:
            return x.mean(dim=dims)
        m = (mask_src if x.dim() == 2 else mask_src[..., None]).expand(x.shape)
        return (x * m).sum(dim=dims) / (m.sum(dim=dims) + 1e-12)

    if cfg.wt_ptDist_loss > 0:
        gt_src = se3.transform(transform_gt, pt_src)
        for i in range(num_iter):
            d = se3.transform(transforms[i], pt_src) - gt_src
            per = point_mean(d * d if cfg.loss_type == "mse" else d.abs())
            out[f"{cfg.loss_type}_{i}"] = red(per * cfg.wt_ptDist_loss)
    else:
        zeros = torch.zeros(pt_src.shape[0], dtype=pt_src.dtype, device=pt_src.device)
        for i in range(num_iter):
            out[f"{cfg.loss_type}_{i}"] = red(zeros)

    geometric = pt_ref is not None and cfg.thres_radius > 0
    if cfg.wt_inlier_loss > 0 and (geometric or gt_matches is not None):
        gt_src = se3.transform(transform_gt, pt_src) if geometric else None
        for i in range(num_iter):
            if geometric:
                dist = torch.linalg.vector_norm(gt_src - gather_points(pt_ref, pred_idx[i]),
                                                dim=-1)
                correct = dist < cfg.thres_radius
            else:
                correct = correspondence_correct(pred_idx[i], gt_matches, num_points)
            labels = correct.to(inlier_logits.dtype)
            logits = inlier_logits[i]
            bce = (torch.clamp(logits, min=0) - logits * labels
                   + torch.log1p(torch.exp(-logits.abs())))
            out[f"outlier_{i}"] = red(point_mean(bce) * cfg.wt_inlier_loss)

    if cfg.wt_pose_loss > 0:
        for i in range(num_iter):
            err_r = se3.rotation_error_rad(transform_gt[..., :3, :3], transforms[i][..., :3, :3])
            err_t = se3.translation_error(transform_gt[..., :3, 3], transforms[i][..., :3, 3])
            out[f"poseError_{i}"] = red((err_r + err_t) * cfg.wt_pose_loss)

    total = 0.0
    for key, val in out.items():
        it = int(key[key.rfind("_") + 1:])
        total = total + val * (cfg.loss_discount_factor ** (num_iter - it - 1))
    out["total"] = total
    return out
