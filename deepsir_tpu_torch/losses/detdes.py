"""Detection + description loss of the feat pipeline: circle loss over
descriptor distances plus a score-weighted detector term
(deepsir_tpu/losses/detdes.py).

The positive and negative sets come from the ground-truth-aligned point
distances as the JAX package builds them, quirks included:
- point distances by direct difference, not by the norm expansion: the
  positive mask tests `dist_pc == dist_min` exactly, and the expansion's
  rounding would turn exact duplicates into ~1e-6;
- the zero-before-min positive mask: out-of-radius entries are zeroed
  before the row min, so `dist_min` is 0 whenever any pair of the row is
  out of radius and only exact duplicates are positives of the detector
  term and the accuracy;
- the circle weights `pos_weight` and `neg_weight` carry no gradient;
- the accuracy is over B * N1 anchors (under `overlap_det_mask`, over the
  anchors with an in-radius correspondent).
`softplus` is `logaddexp(x, 0)`, which is `jax.nn.softplus`; torch's
`softplus` turns linear above its threshold.

Over a data-parallel `group` (the batch split across processes) each mean
over the batch becomes this rank's share of the global batch's mean, so
that the shares sum to the single-device loss, and the accuracy is the
global one (under `overlap_det_mask`, the `has_pos` counts summed over the
group).
"""
from __future__ import annotations

from typing import Tuple

import torch

from deepsir_tpu_torch.config import LossConfig
from deepsir_tpu_torch.math import se3
from deepsir_tpu_torch.ops.cuda_circle import (BIG as _BIG, EPS as _EPS, circle_rows,
                                               dist_feat as _dist_feat, dist_pc as _dist_pc,
                                               largest_divisor as _largest_divisor)
from deepsir_tpu_torch.utils.collectives import (ProcessGroup, global_mean, global_sum,
                                                 share_mean)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _detector(diff, has_pos, score, overlap_det_mask: bool, dim, group: ProcessGroup = None):
    """(accuracy %, detector loss) from diff = furthest positive - closest
    negative, averaged over `dim`: None, every anchor of the batch (over a
    data-parallel `group`, the global accuracy and this rank's share of the
    loss), or -1, each pair's own (`circle_loss_tiled`)."""
    if dim is None:
        if overlap_det_mask:
            counts = global_sum(torch.stack([torch.sum((diff < 0) * has_pos),
                                             torch.sum(has_pos)]).float(), group)
            acc = counts[0] / (counts[1] + _EPS) * 100.0
            det = torch.where(has_pos, diff, torch.zeros_like(diff)) * score
        else:
            acc, det = global_mean((diff < 0) * 100.0, group), diff * score
        return acc, share_mean(det, group)
    if overlap_det_mask:
        # only anchors with an in-radius correspondent
        acc = torch.sum((diff < 0) * has_pos, dim=dim) / (torch.sum(has_pos, dim=dim) + _EPS) * 100.0
        return acc, torch.mean(torch.where(has_pos, diff, torch.zeros_like(diff)) * score, dim=dim)
    return torch.mean((diff < 0) * 100.0, dim=dim), torch.mean(diff * score, dim=dim)


def circle_loss(anc_feat: torch.Tensor, pos_feat: torch.Tensor,
                anc_pc: torch.Tensor, pos_pc: torch.Tensor,
                anc_score: torch.Tensor, thres_radius: float,
                log_scale: float = 10.0, pos_margin: float = 0.1,
                neg_margin: float = 1.4, overlap_det_mask: bool = False,
                group: ProcessGroup = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Circle loss (descriptors) + detector loss + matching accuracy (%).

    anc_feat, pos_feat (B, N1/N2, C); anc_pc, pos_pc (B, N1/N2, 3), pos_pc in
    anchor coordinates; anc_score (B, N1). The row and column terms add
    (B, N1) and (B, N2) vectors, so N1 == N2, as in the reference.
    Returns (loss_feat, loss_det, accuracy) scalars; with a data-parallel
    `group`, this rank's shares of the losses and the global accuracy.
    """
    anc_score = anc_score / (torch.sum(anc_score, dim=1, keepdim=True) + _EPS)
    dist_pc = _dist_pc(anc_pc, pos_pc)
    dist_feat = _dist_feat(anc_feat, pos_feat)

    false_neg = dist_pc < thres_radius                               # (B, N1, N2)
    dist_min = torch.amin(dist_pc * false_neg, dim=-1, keepdim=True)
    pos_mask = dist_pc == dist_min
    neg_mask = ~(pos_mask | false_neg)

    # negatives pushed far down vanish from the positive logsumexp; every
    # in-radius pair counts as a positive there
    pos = dist_feat - _BIG * neg_mask
    pos_weight = torch.clamp_min(pos - pos_margin, 0.0).detach()
    lse_pos = torch.logsumexp(log_scale * (pos - pos_margin) * pos_weight, dim=-1)

    neg = dist_feat + _BIG * (~neg_mask)
    neg_weight = torch.clamp_min(neg_margin - neg, 0.0).detach()
    neg_weighted = log_scale * (neg_margin - neg) * neg_weight
    lse_neg_row = torch.logsumexp(neg_weighted, dim=-1)              # (B, N1)
    lse_neg_col = torch.logsumexp(neg_weighted, dim=-2)              # (B, N2)

    loss_col = softplus(lse_pos + lse_neg_row) / log_scale
    loss_row = softplus(lse_pos + lse_neg_col) / log_scale
    loss_feat = share_mean(loss_col + loss_row, group)

    furthest_pos = torch.amax(dist_feat * pos_mask, dim=-1)
    closest_neg = torch.amin(dist_feat + _BIG * pos_mask, dim=-1)
    acc, loss_det = _detector(furthest_pos - closest_neg, torch.any(false_neg, dim=-1),
                              anc_score, overlap_det_mask, dim=None, group=group)
    return loss_feat, loss_det, acc


def circle_loss_tiled(anc_feat: torch.Tensor, pos_feat: torch.Tensor,
                      anc_pc: torch.Tensor, pos_pc: torch.Tensor,
                      anc_score: torch.Tensor, thres_radius: float,
                      log_scale: float = 10.0, pos_margin: float = 0.1,
                      neg_margin: float = 1.4, overlap_det_mask: bool = False,
                      tile: int = 1500, group: ProcessGroup = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`circle_loss` without a whole (N1, N2) matrix: the row and column
    reductions come from `ops.cuda_circle.circle_rows`, which streams
    columns in tiles of `tile` positives (clamped to the largest divisor of
    N2: padded columns would still add exp(0) to the excluded entries), on
    the CPU in plain PyTorch and on the card through its kernel. As in the
    JAX package, each batch element's losses and accuracy are taken on
    their own and then averaged (over a data-parallel `group`, as
    `circle_loss` does).
    """
    score = anc_score / (torch.sum(anc_score, dim=-1, keepdim=True) + _EPS)
    lse_p, lse_n, furthest, closest, has_pos, lse_neg_col = circle_rows(
        anc_feat, pos_feat, anc_pc, pos_pc, thres_radius, log_scale, pos_margin, neg_margin,
        tile)

    loss_col = softplus(lse_p + lse_n) / log_scale
    loss_row = softplus(lse_p + lse_neg_col) / log_scale
    loss_feat = torch.mean(loss_col + loss_row, dim=-1)
    acc, loss_det = _detector(furthest - closest, has_pos, score, overlap_det_mask, dim=-1)
    return share_mean(loss_feat, group), share_mean(loss_det, group), global_mean(acc, group)


def det_des_loss(feat_src: torch.Tensor, feat_ref: torch.Tensor,
                 pt_src: torch.Tensor, pt_ref: torch.Tensor,
                 score_src: torch.Tensor, score_ref: torch.Tensor,
                 transform_gt: torch.Tensor, cfg: LossConfig, group: ProcessGroup = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The feat pipeline's objective: the source moved into the reference's
    frame by the ground-truth pose, then the circle loss anchored on the
    reference cloud (tiled when `cfg.circle_loss_tile` > 0). `score_src` is
    not read, as in the JAX package. Returns (loss_feat + det_loss_weight *
    loss_det, accuracy %); with a data-parallel `group`, this rank's share
    of the loss and the global accuracy."""
    if cfg.thres_radius <= 0:
        raise ValueError("det_des_loss needs thres_radius > 0 (read_run_config fills it)")
    pt_src_gt = se3.transform(transform_gt, pt_src)
    kw = dict(thres_radius=cfg.thres_radius, overlap_det_mask=cfg.overlap_det_mask,
              group=group)
    if cfg.circle_loss_tile > 0:
        loss_feat, loss_det, acc = circle_loss_tiled(
            feat_ref, feat_src, pt_ref, pt_src_gt, score_ref, tile=cfg.circle_loss_tile, **kw)
    else:
        loss_feat, loss_det, acc = circle_loss(feat_ref, feat_src, pt_ref, pt_src_gt,
                                               score_ref, **kw)
    return loss_feat + loss_det * cfg.det_loss_weight, acc
