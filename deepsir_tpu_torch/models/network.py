"""The align network (deepsir_tpu/models/network.py), inference forward.

One module owns the RandLA feature extractor, the aggregation MLPs and the
inlier RandLA. `forward_align` runs the backbone over both clouds, scores
keypoints, then `num_iter` registration iterations: re-aggregate the source
descriptors at the current pose, nearest-descriptor search (kernel K2 on the
card; K3, both directions, when the mutual gate or the `recip` channel needs
the reverse match), inlier weighting over [src ; matched ref ; extras]
pairs, the optional mutual gate, weighted Kabsch, compose. The ref
descriptor, the inlier net's LocSE cache and mlp_feat of the source features
are computed once, outside the loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from deepsir_tpu_torch.config import ModelConfig, check_supported, inlier_extras
from deepsir_tpu_torch.math import se3
from deepsir_tpu_torch.models.layers import MLP
from deepsir_tpu_torch.models.randla import RandLA
from deepsir_tpu_torch.models.scoring import score_points
from deepsir_tpu_torch.ops.distance import (mutual_gate, nearest_neighbour_bidirectional,
                                            nearest_neighbour_index)
from deepsir_tpu_torch.ops.gather import gather_points
from deepsir_tpu_torch.ops.pyramid import Pyramid, concat_pyramids
from deepsir_tpu_torch.ops.svd3 import weighted_kabsch


class PairBatch(NamedTuple):
    """A batch of cloud pairs with their pyramids (batch-leading)."""
    points_src: torch.Tensor           # (B, N, C) xyz + extra channels
    points_ref: torch.Tensor           # (B, N, C)
    pyramid_src: Pyramid
    pyramid_ref: Pyramid
    transform_gt: torch.Tensor         # (B, 3, 4)


class AlignOutput(NamedTuple):
    transforms: torch.Tensor           # (iters, B, 3, 4) cumulative src->ref
    inlier_logits: torch.Tensor        # (iters, B, N)
    pred_idx: torch.Tensor             # (iters, B, N) matched ref index, int64
    invalid: torch.Tensor              # (B,) bool, any solve failed
    pt_src: torch.Tensor               # (B, N, 3) untransformed source
    pt_ref: torch.Tensor               # (B, N, 3)
    score_src: torch.Tensor            # (B, N)
    score_ref: torch.Tensor


class ForwardOptions(NamedTuple):
    num_iter: int = 2
    clip_weight: bool = False


def l2_normalize(f: torch.Tensor) -> torch.Tensor:
    return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)


class Network(nn.Module):
    """The align pipeline's network. Other pipelines are not ported."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        c = cfg.out_feat_dim
        self.feat_extractor = RandLA(cfg, cfg.num_classes, cfg.feat_len)
        self.mlp_feat = MLP(c, (c, 128, c))
        self.mlp_att = MLP(4, (32, 64, 128, 256, c))
        self.mlp_proj = MLP(c, (c,))
        # [src xyz ; matched ref xyz] plus one channel per extra feature
        self.extras = inlier_extras(cfg)
        self.inlier_model = RandLA(cfg, 1, 6 + len(self.extras))

    def aggregate_side(self, xyz, feat, score):
        """One cloud's L2-normalised descriptor: proj(mlp_feat(f) + mlp_att([xyz; s]))."""
        return self.aggregate_moving(xyz, score, self.mlp_feat(feat))

    def aggregate_moving(self, xyz, score, ff):
        """Descriptor from a precomputed `ff = mlp_feat(feat)` at the pose of xyz."""
        g = self.mlp_att(torch.cat([xyz, score[..., None]], dim=-1))
        return l2_normalize(self.mlp_proj(ff + g))

    def backbone_pair(self, batch: PairBatch):
        """One backbone pass over src and ref stacked along the batch dim."""
        b = batch.points_src.shape[0]
        pts = torch.cat([batch.points_src, batch.points_ref], dim=0)
        pyr = concat_pyramids(batch.pyramid_src, batch.pyramid_ref)
        feat, logits = self.feat_extractor(pts, pyr)
        return feat[:b], logits[:b], feat[b:], logits[b:]

    def score_pair(self, batch: PairBatch, feat_src, feat_ref, logits_src, logits_ref):
        """Keypoint scores of both clouds in one stacked call."""
        b = batch.points_src.shape[0]
        score = score_points(
            torch.cat([feat_src, feat_ref], dim=0),
            torch.cat([batch.points_src[..., :3], batch.points_ref[..., :3]], dim=0),
            torch.cat([logits_src, logits_ref], dim=0),
            torch.cat([batch.pyramid_src.neigh_idx[0],
                       batch.pyramid_ref.neigh_idx[0]], dim=0))
        return score[:b], score[b:]

    @torch.no_grad()
    def forward_align(self, batch: PairBatch, opts: ForwardOptions) -> AlignOutput:
        """Iterative registration, inference only."""
        cfg = self.cfg
        feat_src0, logits_src, feat_ref0, logits_ref = self.backbone_pair(batch)
        xyz_src0 = batch.points_src[..., :3]
        xyz_ref = batch.points_ref[..., :3].contiguous()
        score_src, score_ref = self.score_pair(batch, feat_src0, feat_ref0,
                                               logits_src, logits_ref)

        # loop-invariant: the ref descriptor, the inlier LocSE cache and
        # mlp_feat of the source features
        fr = self.aggregate_side(xyz_ref, feat_ref0, score_ref)
        pyr = batch.pyramid_src
        inlier_pos = self.inlier_model.pos_cache(pyr)
        ff_src = self.mlp_feat(feat_src0)

        b = xyz_src0.shape[0]
        xyz_src = xyz_src0
        cum = se3.identity((b,), device=xyz_src0.device, dtype=xyz_src0.dtype)
        invalid = torch.zeros(b, dtype=torch.bool, device=xyz_src0.device)
        need_ridx = cfg.mutual_check or "recip" in self.extras
        transforms, logits_iters, idx_iters = [], [], []
        for _ in range(opts.num_iter):
            fs = self.aggregate_moving(xyz_src, score_src, ff_src)
            if need_ridx:
                idx, ridx = nearest_neighbour_bidirectional(fs, fr)     # (B, N), (B, M)
            else:
                idx = nearest_neighbour_index(fs, fr)                   # (B, N)
            xyz_ref_new = gather_points(xyz_ref, idx)
            # the extra channels stack as [dist, recip] whatever the order of
            # the config string, as the reference stacks them
            feats = [xyz_src, xyz_ref_new]
            if "dist" in self.extras:
                feats.append(torch.linalg.vector_norm(
                    fs - gather_points(fr, idx), dim=-1, keepdim=True))
            if "recip" in self.extras:
                # |src_i - src[reverse(idx_i)]| in untransformed coordinates
                back = gather_points(xyz_src0, ridx)                    # (B, M, 3)
                feats.append(torch.linalg.vector_norm(
                    gather_points(back, idx) - xyz_src0, dim=-1, keepdim=True))
            pair_feats = torch.cat(feats, dim=-1)
            _, logit = self.inlier_model(pair_feats, pyr, pos_cache=inlier_pos)
            logit = logit[..., 0]
            weights = torch.sigmoid(logit)
            if opts.clip_weight and cfg.clip_weight_thresh > 0:
                weights = torch.where(weights < cfg.clip_weight_thresh,
                                      torch.zeros_like(weights), weights)
            if cfg.mutual_check:
                weights = weights * mutual_gate(idx, ridx, src_xyz=xyz_src0,
                                                tol=cfg.mutual_check_tol)
            r_t, bad = weighted_kabsch(xyz_src, xyz_ref_new, weights)
            xyz_src = se3.transform(r_t, xyz_src)
            cum = se3.concatenate(r_t, cum)
            invalid = invalid | bad
            transforms.append(cum)
            logits_iters.append(logit)
            idx_iters.append(idx)
        return AlignOutput(
            transforms=torch.stack(transforms), inlier_logits=torch.stack(logits_iters),
            pred_idx=torch.stack(idx_iters), invalid=invalid,
            pt_src=xyz_src0, pt_ref=xyz_ref, score_src=score_src, score_ref=score_ref)
