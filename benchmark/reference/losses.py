"""The reference's losses in plain PyTorch: the align pipeline's scan
alignment loss with geometric inlier labels, and the feat pipeline's circle
and detector loss over column tiles.

A frozen copy of the plain paths of the port's `losses/align.py` and
`losses/detdes.py` (one device, `loss_type` "mae" or "mse", no pose term,
no match lists, no overlap mask). `loss` is the "loss" block of a traffic
file as a namespace. Nothing here imports the port.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.ops import gather_points, se3_transform

_BIG = 1e5
_EPS = 1e-12


def scan_alignment_loss(out: Dict[str, torch.Tensor], transform_gt: torch.Tensor,
                        loss) -> Dict[str, torch.Tensor]:
    """Per-iteration point distance and inlier BCE, discounted; keys
    f"{loss_type}_{i}", f"outlier_{i}" and "total"."""
    transforms, logits_all, pred_idx = out["transforms"], out["inlier_logits"], out["pred_idx"]
    pt_src, pt_ref = out["pt_src"], out["pt_ref"]
    num_iter = transforms.shape[0]
    gt_src = se3_transform(transform_gt, pt_src)
    terms: Dict[str, torch.Tensor] = {}
    for i in range(num_iter):
        d = se3_transform(transforms[i], pt_src) - gt_src
        per = (d * d if loss.loss_type == "mse" else d.abs()).mean(dim=(1, 2))
        terms[f"{loss.loss_type}_{i}"] = (per * loss.wt_ptDist_loss).mean()
    for i in range(num_iter):
        dist = torch.linalg.vector_norm(gt_src - gather_points(pt_ref, pred_idx[i]), dim=-1)
        labels = (dist < loss.thres_radius).to(logits_all.dtype)
        logits = logits_all[i]
        bce = (torch.clamp(logits, min=0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs())))
        terms[f"outlier_{i}"] = (bce.mean(dim=1) * loss.wt_inlier_loss).mean()
    total = 0.0
    for key, val in terms.items():
        it = int(key[key.rfind("_") + 1:])
        total = total + val * (loss.loss_discount_factor ** (num_iter - it - 1))
    terms["total"] = total
    return terms


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _dist_pc(a, b):
    return torch.linalg.vector_norm(a[..., :, None, :] - b[..., None, :, :], dim=-1)


def _dist_feat(a, b):
    d = -2.0 * torch.einsum("...nc,...mc->...nm", a, b)
    d = d + torch.sum(a * a, dim=-1)[..., :, None]
    d = d + torch.sum(b * b, dim=-1)[..., None, :]
    return torch.sqrt(torch.clamp_min(d, 0.0) + _EPS)


def _largest_divisor(n: int, tile: int) -> int:
    t = max(1, min(tile, n))
    while n % t:
        t -= 1
    return t


def circle_loss_tiled(anc_feat, pos_feat, anc_pc, pos_pc, anc_score, thres_radius: float,
                      tile: int, log_scale: float = 10.0, pos_margin: float = 0.1,
                      neg_margin: float = 1.4):
    """Circle loss plus the score-weighted detector loss over column tiles:
    (loss_feat, loss_det), each averaged over the batch."""
    t = _largest_divisor(pos_feat.shape[-2], tile)
    score = anc_score / (torch.sum(anc_score, dim=-1, keepdim=True) + _EPS)
    tiles = list(zip(torch.split(pos_feat, t, dim=-2), torch.split(pos_pc, t, dim=-2)))
    with torch.no_grad():
        dist_min = torch.full(anc_feat.shape[:-1], float("inf"), device=anc_feat.device)
        for _, pc in tiles:
            dist_pc = _dist_pc(anc_pc, pc)
            dist_min = torch.minimum(dist_min,
                                     torch.amin(dist_pc * (dist_pc < thres_radius), dim=-1))
    shape = anc_feat.shape[:-1]
    dev = anc_feat.device
    lse_p = torch.full(shape, -float("inf"), device=dev)
    lse_n = torch.full(shape, -float("inf"), device=dev)
    furthest = torch.full(shape, -float("inf"), device=dev)
    closest = torch.full(shape, float("inf"), device=dev)
    cols = []
    for pf, pc in tiles:
        dist_pc = _dist_pc(anc_pc, pc)
        dist_feat = _dist_feat(anc_feat, pf)
        false_neg = dist_pc < thres_radius
        pos_mask = dist_pc == dist_min[..., None]
        neg_mask = ~(pos_mask | false_neg)
        pos = dist_feat - _BIG * neg_mask
        pos_w = torch.clamp_min(pos - pos_margin, 0.0).detach()
        lse_p = torch.logaddexp(lse_p, torch.logsumexp(log_scale * (pos - pos_margin) * pos_w,
                                                       dim=-1))
        neg = dist_feat + _BIG * (~neg_mask)
        neg_w = torch.clamp_min(neg_margin - neg, 0.0).detach()
        neg_weighted = log_scale * (neg_margin - neg) * neg_w
        lse_n = torch.logaddexp(lse_n, torch.logsumexp(neg_weighted, dim=-1))
        cols.append(torch.logsumexp(neg_weighted, dim=-2))
        furthest = torch.maximum(furthest, torch.amax(dist_feat * pos_mask, dim=-1))
        closest = torch.minimum(closest, torch.amin(dist_feat + _BIG * pos_mask, dim=-1))
    loss_col = _softplus(lse_p + lse_n) / log_scale
    loss_row = _softplus(lse_p + torch.cat(cols, dim=-1)) / log_scale
    loss_feat = torch.mean(loss_col + loss_row, dim=-1)
    loss_det = torch.mean((furthest - closest) * score, dim=-1)
    return loss_feat.mean(), loss_det.mean()


def det_des_loss(desc_src, desc_ref, pt_src, pt_ref, score_ref, transform_gt, loss):
    """The feat objective, anchored on the reference cloud: {"total"}."""
    pt_src_gt = se3_transform(transform_gt, pt_src)
    loss_feat, loss_det = circle_loss_tiled(desc_ref, desc_src, pt_ref, pt_src_gt, score_ref,
                                            loss.thres_radius, loss.circle_loss_tile)
    return {"total": loss_feat + loss_det * loss.det_loss_weight}
