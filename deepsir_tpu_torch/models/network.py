"""The network of the three pipelines (deepsir_tpu/models/network.py): its
forwards, for inference and for training.

`Network(cfg, pipeline)` builds what the JAX package's `setup` builds for
the pipeline: the RandLA feature extractor (label); and the aggregation
MLPs (feat); and the inlier RandLA (align). `forward_pair` is the label and
feat forward: the backbone over both clouds and, for feat, keypoint scores
and the aggregated descriptors, optionally cut to the `num_sub` best-scored
points. In feat training the backbone is frozen: it runs without a graph,
as JAX's stop_gradient cuts it.

`forward_align` runs the backbone over both clouds, scores
keypoints, then `num_iter` registration iterations: re-aggregate the source
descriptors at the current pose, nearest-descriptor search (kernel K2 on the
card; K3, both directions, when the mutual gate or the `recip` channel needs
the reverse match), inlier weighting over [src ; matched ref ; extras]
pairs, the validity mask, the optional mutual gate, weighted Kabsch, compose
(or, under `absolute_pose_solve`, solve the original source directly). The
ref descriptor, the inlier net's LocSE cache and mlp_feat of the source
features are computed once, outside the loop. With
`ForwardOptions.refine_stride` > 1 iterations 2.. run on every stride-th
source point, over a second pyramid built inside the forward.

Training (`forward_align(..., train=True)`) differentiates only what the
reference's stop_gradients let through: the inlier net (its LocSE cache
included), the Kabsch solves and the composed poses. The backbone, the
scores, the descriptors, the searches and the inlier net's input channels
are computed without a graph.

The correspondence search hook (deepsir_tpu/models/network.py:109-113,
349-371): `Network.matcher`, None by default, is a parameter-free callable
(feat_src (B, N, C), feat_ref (B, M, C)) -> (B, N) int64. When it is set
the loop searches with it, and where the reverse match is needed calls it
again with the clouds swapped instead of running K3; the multi-device path
sets the ring-sharded matcher here (parallel/matching.py). The state dict
does not change.

Data parallelism: each forward takes `group`, the process group of the
data axis when the batch is split across processes (None on one device,
which changes nothing). It reaches the batch norm of the FC stacks under
`fc_norm="batch"` and the dropout's draw (models/randla.py), the only
places where the forward mixes the pairs of a batch.

Precision (deepsir_tpu/models/network.py:129-151,347-366): the backbone
and the aggregation MLPs run their Dense layers in `compute_dtype`, the
inlier RandLA in `inlier_compute_dtype` (and never on point-pair
features); under `compute_dtype="bfloat16"` the loop's searches take bf16
operands (K2/K3's `low_precision` form). Descriptors, logits, weights and
poses are fp32.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from deepsir_tpu_torch.config import (PIPELINES, ModelConfig, check_supported, inlier_extras,
                                      replace)
from deepsir_tpu_torch.math import se3
from deepsir_tpu_torch.models.layers import MLP, compute_dtype
from deepsir_tpu_torch.models.randla import RandLA
from deepsir_tpu_torch.models.scoring import score_points, top_k_select
from deepsir_tpu_torch.ops.distance import (mutual_gate, nearest_neighbour_bidirectional,
                                            nearest_neighbour_index)
from deepsir_tpu_torch.ops.gather import gather_points
from deepsir_tpu_torch.ops.pyramid import (Pyramid, build_cloud_pyramid, concat_pyramids,
                                           slice_neighbours)
from deepsir_tpu_torch.ops.svd3 import weighted_kabsch
from deepsir_tpu_torch.utils.collectives import ProcessGroup
from deepsir_tpu_torch.utils.profiling import span


class PairBatch(NamedTuple):
    """A batch of cloud pairs with their pyramids (batch-leading)."""
    points_src: torch.Tensor           # (B, N, C) xyz + extra channels
    points_ref: torch.Tensor           # (B, N, C)
    pyramid_src: Pyramid
    pyramid_ref: Pyramid
    transform_gt: torch.Tensor         # (B, 3, 4)
    # validity of ragged clouds padded to N by tile duplication (1.0 a real
    # point, 0.0 padding; None: all real). The forward reads only mask_src.
    mask_src: Optional[torch.Tensor] = None    # (B, N) float32
    mask_ref: Optional[torch.Tensor] = None
    # ground-truth (src, ref) match lists padded with -1, for the list BCE
    matches: Optional[torch.Tensor] = None     # (B, M_cap, 2) int32
    num_matches: Optional[torch.Tensor] = None  # (B,) int32
    # raw semantic labels 0..19 (0 ignored), for the label loss
    labels_src: Optional[torch.Tensor] = None  # (B, N) int32
    labels_ref: Optional[torch.Tensor] = None


class PairOutput(NamedTuple):
    """forward_pair's outputs. Under feat with num_sub > 0 the points,
    descriptors and scores are the num_sub best-scored of each cloud."""
    feat_src: torch.Tensor             # (B, N, C) descriptors
    feat_ref: torch.Tensor
    xyz_src: torch.Tensor              # (B, N, 3)
    xyz_ref: torch.Tensor
    logits_src: torch.Tensor           # (B, N, num_classes), all points
    logits_ref: torch.Tensor
    score_src: Optional[torch.Tensor] = None    # (B, N)
    score_ref: Optional[torch.Tensor] = None


class AlignOutput(NamedTuple):
    """With refine_stride > 1, pt_src, inlier_logits and pred_idx describe the
    strided source subset and the refinement iterations only; transforms
    stacks all num_iter poses (deepsir_tpu/models/network.py:483-489)."""
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
    # iterations 2.. on every stride-th source point (1: all on every point)
    refine_stride: int = 1


class _Source(NamedTuple):
    """What the registration iterations read of the source cloud."""
    xyz0: torch.Tensor                 # (B, N, 3) untransformed
    score: torch.Tensor                # (B, N)
    ff: torch.Tensor                   # (B, N, C) mlp_feat of the backbone features
    pyramid: Pyramid                   # the inlier net's neighbour lists
    pos: tuple                         # the inlier net's LocSE cache
    mask: Optional[torch.Tensor]       # (B, N) validity, or None


def l2_normalize(f: torch.Tensor) -> torch.Tensor:
    return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)


class Network(nn.Module):
    """The network of one pipeline ("label", "feat" or "align")."""

    def __init__(self, cfg: ModelConfig, pipeline: str = "align"):
        super().__init__()
        check_supported(cfg, pipeline)
        if pipeline not in PIPELINES:
            raise ValueError(f"pipeline {pipeline!r} is not one of {PIPELINES}")
        self.cfg = cfg
        self.pipeline = pipeline
        # the correspondence search override (module docstring); parameter-free
        self.matcher: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None
        c = cfg.out_feat_dim
        self.feat_extractor = RandLA(cfg, cfg.num_classes, cfg.feat_len)
        # [src xyz ; matched ref xyz] plus one channel per extra feature
        self.extras = inlier_extras(cfg)
        # the searches of the registration loop take bf16 operands under bf16 compute
        self.low_precision = cfg.compute_dtype == "bfloat16"
        if pipeline != "label":
            dtype = compute_dtype(cfg.compute_dtype)
            self.mlp_feat = MLP(c, (c, 128, c), norm=cfg.fc_norm, dtype=dtype)
            self.mlp_att = MLP(4, (32, 64, 128, 256, c), norm=cfg.fc_norm, dtype=dtype)
            self.mlp_proj = MLP(c, (c,), norm=cfg.fc_norm, dtype=dtype)
        if pipeline == "align":
            # inlier_num_layers > 0 keeps the first levels, which read the
            # first levels of the same source pyramid
            L = cfg.inlier_num_layers or len(cfg.d_out)
            self.inlier_model = RandLA(
                replace(cfg, d_out=cfg.d_out[:L], sub_sampling_ratio=cfg.sub_sampling_ratio[:L],
                        use_ppf=False, compute_dtype=cfg.inlier_compute_dtype),
                1, 6 + len(self.extras))

    def aggregate_side(self, xyz, feat, score, group: ProcessGroup = None):
        """One cloud's L2-normalised descriptor: proj(mlp_feat(f) + mlp_att([xyz; s]))."""
        return self.aggregate_moving(xyz, score, self.mlp_feat(feat, group), group)

    def aggregate_moving(self, xyz, score, ff, group: ProcessGroup = None):
        """Descriptor from a precomputed `ff = mlp_feat(feat)` at the pose of xyz."""
        g = self.mlp_att(torch.cat([xyz, score[..., None]], dim=-1), group)
        return l2_normalize(self.mlp_proj(ff + g, group))

    def backbone_pair(self, batch: PairBatch, train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      group: ProcessGroup = None):
        """One backbone pass over src and ref stacked along the batch dim, on
        the first `backbone_num_knn` neighbours when that is > 0. In
        training the dropout before `fc_label` draws from `generator`."""
        b = batch.points_src.shape[0]
        with span("deepsir.backbone"):
            pts = torch.cat([batch.points_src, batch.points_ref], dim=0)
            pyr = slice_neighbours(concat_pyramids(batch.pyramid_src, batch.pyramid_ref),
                                   self.cfg.backbone_num_knn)
            feat, logits = self.feat_extractor(pts, pyr, train=train, generator=generator,
                                               group=group, stacked=2)
        return feat[:b], logits[:b], feat[b:], logits[b:]

    def score_pair(self, batch: PairBatch, feat_src, feat_ref, logits_src, logits_ref):
        """Keypoint scores of both clouds in one stacked call."""
        b = batch.points_src.shape[0]
        with span("deepsir.score"):
            neigh = torch.cat([batch.pyramid_src.neigh_idx[0], batch.pyramid_ref.neigh_idx[0]],
                              dim=0)
            if self.cfg.backbone_num_knn > 0:
                # the backbone's neighbourhoods
                neigh = neigh[..., :self.cfg.backbone_num_knn]
            score = score_points(
                torch.cat([feat_src, feat_ref], dim=0),
                torch.cat([batch.points_src[..., :3], batch.points_ref[..., :3]], dim=0),
                torch.cat([logits_src, logits_ref], dim=0), neigh)
        return score[:b], score[b:]

    def forward_pair(self, batch: PairBatch, train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     group: ProcessGroup = None) -> PairOutput:
        """Features of both clouds, with keypoint scores for feat and align.
        Under feat the descriptors are the
        aggregated ones, cut to the `num_sub` best-scored points when
        num_sub > 0 (equal scores keep the lower index); label and align
        return the backbone features L2-normalised. Under feat the backbone
        runs without a graph; otherwise the outputs keep theirs (the caller
        picks `torch.no_grad` for inference, as `training.forward_step`
        does). `train` runs the backbone's dropout from `generator`."""
        cfg = self.cfg
        with torch.no_grad() if self.pipeline == "feat" else nullcontext():
            feat_src, logits_src, feat_ref, logits_ref = self.backbone_pair(
                batch, train, generator, group)
        xyz_src = batch.points_src[..., :3]
        xyz_ref = batch.points_ref[..., :3]
        score_src = score_ref = None
        if self.pipeline != "label":
            score_src, score_ref = self.score_pair(batch, feat_src, feat_ref,
                                                   logits_src, logits_ref)
            if self.pipeline == "feat":
                with span("deepsir.descriptor"):
                    feat_src = self.aggregate_side(xyz_src, feat_src, score_src, group)
                    feat_ref = self.aggregate_side(xyz_ref, feat_ref, score_ref, group)
                    if cfg.num_sub > 0:
                        score_src, xyz_src, feat_src = top_k_select(score_src, cfg.num_sub,
                                                                    xyz_src, feat_src)
                        score_ref, xyz_ref, feat_ref = top_k_select(score_ref, cfg.num_sub,
                                                                    xyz_ref, feat_ref)
        if self.pipeline != "feat":
            feat_src, feat_ref = l2_normalize(feat_src), l2_normalize(feat_ref)
        return PairOutput(feat_src, feat_ref, xyz_src, xyz_ref, logits_src, logits_ref,
                          score_src, score_ref)

    def _source(self, xyz0, score, ff, pyramid, mask) -> _Source:
        pyr = slice_neighbours(pyramid, self.cfg.inlier_num_knn)
        with span("deepsir.inlier_cache"):
            pos = self.inlier_model.pos_cache(pyr)
        return _Source(xyz0, score, ff, pyr, pos, mask)

    def forward_align(self, batch: PairBatch, opts: ForwardOptions, train: bool = False,
                      generator: Optional[torch.Generator] = None,
                      group: ProcessGroup = None) -> AlignOutput:
        """Iterative registration.

        With train=False (inference) nothing keeps a graph. With train=True
        the inlier net runs its dropout from `generator` (a fresh mask each
        iteration), `refine_stride` is ignored, and the outputs' graph
        reaches the inlier net's parameters only (through the logits and the
        transforms).
        """
        if not train:
            with torch.no_grad():
                return self._forward_align(batch, opts, False, None, group)
        return self._forward_align(batch, opts, True, generator, group)

    def _forward_align(self, batch: PairBatch, opts: ForwardOptions, train: bool,
                       generator: Optional[torch.Generator],
                       group: ProcessGroup) -> AlignOutput:
        cfg = self.cfg
        stride = 1 if train else opts.refine_stride
        refine = stride > 1 and opts.num_iter > 1
        xyz_src0 = batch.points_src[..., :3]
        if refine:
            n_bottom = len(range(0, xyz_src0.shape[1], stride))
            for r in cfg.sub_sampling_ratio:
                n_bottom //= r
            if n_bottom < 1:
                raise ValueError(f"refine_stride={stride} leaves too few points for the "
                                 f"inlier pyramid (ratios {cfg.sub_sampling_ratio})")
        xyz_ref = batch.points_ref[..., :3].contiguous()
        with torch.no_grad():
            # frozen in align training: backbone, scores and descriptors
            feat_src0, logits_src, feat_ref0, logits_ref = self.backbone_pair(
                batch, group=group)
            score_src, score_ref = self.score_pair(batch, feat_src0, feat_ref0,
                                                   logits_src, logits_ref)
            # loop-invariant: the ref descriptor and mlp_feat of the source
            # features; the inlier LocSE cache (below) keeps its graph
            with span("deepsir.descriptor"):
                fr = self.aggregate_side(xyz_ref, feat_ref0, score_ref, group)
                ff_src = self.mlp_feat(feat_src0, group)
        full = self._source(xyz_src0, score_src, ff_src, batch.pyramid_src, batch.mask_src)

        b = xyz_src0.shape[0]
        cum = se3.identity((b,), device=xyz_src0.device, dtype=xyz_src0.dtype)
        invalid = torch.zeros(b, dtype=torch.bool, device=xyz_src0.device)
        _, cum, invalid, transforms, logits, idx = self._iterate(
            full, fr, xyz_ref, xyz_src0, cum, invalid,
            1 if refine else opts.num_iter, opts.clip_weight, train, generator, group)
        src = full
        if refine:
            # iteration 1 ran on every point; the rest run on the strided
            # subset, over its own pyramid and LocSE cache, entered at the
            # pose iteration 1 reached
            xyz0_sub = xyz_src0[:, ::stride].contiguous()
            mask = batch.mask_src
            src = self._source(xyz0_sub, score_src[:, ::stride], ff_src[:, ::stride],
                               build_cloud_pyramid(cfg, xyz0_sub),
                               None if mask is None else mask[:, ::stride])
            _, cum, invalid, t_rest, logits, idx = self._iterate(
                src, fr, xyz_ref, se3.transform(cum, xyz0_sub), cum, invalid,
                opts.num_iter - 1, opts.clip_weight, group=group)
            transforms = transforms + t_rest
        return AlignOutput(
            transforms=torch.stack(transforms), inlier_logits=torch.stack(logits),
            pred_idx=torch.stack(idx), invalid=invalid,
            pt_src=src.xyz0, pt_ref=xyz_ref, score_src=score_src, score_ref=score_ref)

    def _iterate(self, src: _Source, fr, xyz_ref, xyz_src, cum, invalid, num_iter: int,
                 clip_weight: bool, train: bool = False,
                 generator: Optional[torch.Generator] = None, group: ProcessGroup = None):
        """`num_iter` registration iterations over `src` from the pose
        (xyz_src, cum); returns the last (xyz_src, cum, invalid) and the
        per-iteration cumulative transforms, inlier logits and matches."""
        cfg = self.cfg
        need_ridx = cfg.mutual_check or "recip" in self.extras
        transforms, logits_iters, idx_iters = [], [], []
        for _ in range(num_iter):
            with torch.no_grad():
                # the inlier net's inputs carry no gradient
                with span("deepsir.loop.aggregate"):
                    fs = self.aggregate_moving(xyz_src, src.score, src.ff, group)
                lp = self.low_precision
                with span("deepsir.loop.search"):
                    # idx (B, N); ridx (B, M), the reverse match
                    if self.matcher is not None:
                        # the reverse call shards the source cloud: the matcher
                        # is argument-generic
                        idx = self.matcher(fs, fr)
                        ridx = self.matcher(fr, fs) if need_ridx else None
                    elif need_ridx:
                        idx, ridx = nearest_neighbour_bidirectional(fs, fr, lp)
                    else:
                        idx = nearest_neighbour_index(fs, fr, lp)
                with span("deepsir.loop.inputs"):
                    xyz_ref_new = gather_points(xyz_ref, idx)
                    # the extra channels stack as [dist, recip] whatever the order
                    # of the config string, as the reference stacks them
                    feats = [xyz_src, xyz_ref_new]
                    if "dist" in self.extras:
                        feats.append(torch.linalg.vector_norm(
                            fs - gather_points(fr, idx), dim=-1, keepdim=True))
                    if "recip" in self.extras:
                        # |src_i - src[reverse(idx_i)]| in untransformed coordinates
                        back = gather_points(src.xyz0, ridx)                    # (B, M, 3)
                        feats.append(torch.linalg.vector_norm(
                            gather_points(back, idx) - src.xyz0, dim=-1, keepdim=True))
                    pair_feats = torch.cat(feats, dim=-1)
            with span("deepsir.loop.inlier"):
                _, logit = self.inlier_model(pair_feats, src.pyramid, pos_cache=src.pos,
                                             train=train, generator=generator, group=group)
                logit = logit[..., 0]
            with span("deepsir.loop.gate"):
                weights = torch.sigmoid(logit)
                if clip_weight and cfg.clip_weight_thresh > 0:
                    weights = torch.where(weights < cfg.clip_weight_thresh,
                                          torch.zeros_like(weights), weights)
                if src.mask is not None:
                    # padded rows duplicate real points: no double vote
                    weights = weights * src.mask
                if cfg.mutual_check:
                    weights = weights * mutual_gate(idx, ridx, src_xyz=src.xyz0,
                                                    tol=cfg.mutual_check_tol)
            with span("deepsir.loop.pose"):
                if cfg.absolute_pose_solve:
                    # the untransformed source straight onto the matched refs
                    cum, bad = weighted_kabsch(src.xyz0, xyz_ref_new, weights)
                    xyz_src = se3.transform(cum.detach(), src.xyz0)
                else:
                    r_t, bad = weighted_kabsch(xyz_src, xyz_ref_new, weights)
                    xyz_src = se3.transform(r_t.detach(), xyz_src)
                    cum = se3.concatenate(r_t, cum)
                invalid = invalid | bad
            transforms.append(cum)
            logits_iters.append(logit)
            idx_iters.append(idx)
        return xyz_src, cum, invalid, transforms, logits_iters, idx_iters
