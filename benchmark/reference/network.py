"""The reference network in plain PyTorch: RandLA-Net over an index pyramid,
keypoint scoring, the aggregation heads and the registration loop.

A frozen copy of the plain paths of the port's `models/layers.py`,
`models/randla.py`, `models/scoring.py` and `models/network.py`, cut to what
the benchmark's configurations run: group norm, 'pre' decoder skips, fp32,
no point-pair features, shuffled clouds, the inlier extras "dist" and
"recip", no mutual gate. Module and parameter names are the port's, so one
state dict made by the benchmark loads into both. `cfg` is the "model" block
of a configuration file as a namespace. Nothing here imports the port.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.ops import (Pyramid, build_pyramid, concat_pyramids, gather_neighbour,
                                     gather_points, match, se3_concatenate, se3_identity,
                                     se3_transform, weighted_kabsch)

LEAKY_SLOPE = 0.2
LABEL_WEIGHTS = (3, 1, 1, 3, 2, 0, 0, 0, 6, 5, 6, 4, 7, 7, 6, 8, 4, 9, 9)
AGGREGATION_BALL_R = 2.0
PROB_GATE = 0.2
_EPS = 1e-16


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


class GroupNorm(nn.Module):
    """Channels-last GroupNorm: statistics per sample and group over every
    other axis, eps 1e-5, per-channel affine."""

    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[0], x.shape[-1]
        xg = x.reshape(b, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
        y = (xg - mean) * torch.rsqrt(var + 1e-5)
        return y.reshape(x.shape) * self.weight + self.bias


class ConvUnit(nn.Module):
    def __init__(self, c_in, c_out, use_norm=True, use_act=True):
        super().__init__()
        self.dense = nn.Linear(c_in, c_out)
        self.norm = GroupNorm(8 if c_out >= 64 else 4, c_out) if use_norm else None
        self.use_act = use_act

    def forward(self, x):
        x = self.dense(x)
        if self.norm is not None:
            x = self.norm(x)
        return leaky_relu(x) if self.use_act else x


class MLP(nn.Module):
    def __init__(self, c_in, channels):
        super().__init__()
        units = []
        for i, ch in enumerate(channels):
            last = i == len(channels) - 1
            units.append(ConvUnit(c_in, ch, use_norm=not last, use_act=not last))
            c_in = ch
        self.units = nn.ModuleList(units)

    def forward(self, x):
        for unit in self.units:
            x = unit(x)
        return x


class AttPooling(nn.Module):
    def __init__(self, c_in, d_out):
        super().__init__()
        self.dense = nn.Linear(c_in, c_in, bias=False)
        self.unit = ConvUnit(c_in, d_out)

    def forward(self, feature_set):
        att = torch.softmax(self.dense(feature_set), dim=-2)
        return self.unit(torch.sum(feature_set * att, dim=-2))


def relative_pos_encoding(xyz, neigh_idx):
    neigh_xyz = gather_neighbour(xyz, neigh_idx)
    center = xyz[..., :, None, :]
    rel = neigh_xyz - center
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True) + 1e-20)
    return torch.cat([dist, rel, center.expand(neigh_xyz.shape), neigh_xyz], dim=-1)


class BuildingBlock(nn.Module):
    def __init__(self, d_out):
        super().__init__()
        half = d_out // 2
        self.mlp1 = ConvUnit(10, half)
        self.att_pooling_1 = AttPooling(d_out, half)
        self.mlp2 = ConvUnit(half, half)
        self.att_pooling_2 = AttPooling(d_out, d_out)

    def pos_encode(self, xyz, neigh_idx):
        p1 = self.mlp1(relative_pos_encoding(xyz, neigh_idx))
        return p1, self.mlp2(p1)

    def forward(self, xyz, feature, neigh_idx, pos=None):
        p1, p2 = pos if pos is not None else self.pos_encode(xyz, neigh_idx)
        f_agg = self.att_pooling_1(torch.cat([gather_neighbour(feature, neigh_idx), p1], dim=-1))
        return self.att_pooling_2(torch.cat([gather_neighbour(f_agg, neigh_idx), p2], dim=-1))


class DilatedResBlock(nn.Module):
    def __init__(self, c_in, d_out):
        super().__init__()
        self.mlp1 = ConvUnit(c_in, d_out // 2)
        self.lfa = BuildingBlock(d_out)
        self.mlp2 = ConvUnit(d_out, d_out * 2, use_act=False)
        self.mlp_skip = ConvUnit(c_in, d_out * 2, use_act=False)

    def forward(self, feature, xyz, neigh_idx, pos=None):
        f_pc = self.mlp2(self.lfa(xyz, self.mlp1(feature), neigh_idx, pos=pos))
        return leaky_relu(f_pc + self.mlp_skip(feature))


class RandLA(nn.Module):
    """features (B, N, F), pyramid -> (feat (B, N, out_feat_dim), logits (B, N, classes))."""

    def __init__(self, cfg, num_classes: int, feat_len: int):
        super().__init__()
        d = tuple(cfg.d_out)
        L = len(d)
        self.mlp_pre = ConvUnit(feat_len, 8)
        c_in = [8] + [2 * x for x in d[:-1]]
        self.enc = nn.ModuleList(DilatedResBlock(c, x) for c, x in zip(c_in, d))
        self.mlp_mid = ConvUnit(2 * d[-1], 2 * d[-1])
        dec, x_ch = [], 2 * d[-1]
        for j in range(L):
            out = 2 * d[max(L - j - 2, 0)]
            dec.append(ConvUnit(2 * d[L - j - 1] + x_ch, out))
            x_ch = out
        self.dec = nn.ModuleList(dec)
        self.mlp_out = nn.Linear(x_ch, cfg.out_feat_dim, bias=False)
        self.fc_label = MLP(cfg.out_feat_dim, (cfg.out_feat_dim, 32, num_classes))
        self.dropout_rate = cfg.dropout_rate

    def pos_cache(self, pyr: Pyramid):
        return tuple(enc.lfa.pos_encode(pyr.xyz[i], pyr.neigh_idx[i])
                     for i, enc in enumerate(self.enc))

    def dropout(self, feat, generator, stacked: int):
        """Each entry kept with probability 1 - rate and scaled by 1 / keep;
        the uniform draw has feat's shape as (stacked, rows, ...)."""
        if self.dropout_rate == 0.0:
            return feat
        keep = 1.0 - self.dropout_rate
        rows = feat.shape[0] // stacked
        draw = torch.rand((stacked, rows) + feat.shape[1:], generator=generator,
                          device=feat.device, dtype=feat.dtype).reshape(feat.shape)
        return torch.where(draw < keep, feat / keep, torch.zeros_like(feat))

    def forward(self, features, pyr: Pyramid, pos_cache=None, train=False, generator=None,
                stacked: int = 1):
        x = self.mlp_pre(features)
        skips = []
        for i, enc in enumerate(self.enc):
            x = enc(x, pyr.xyz[i], pyr.neigh_idx[i], pos=pos_cache[i] if pos_cache else None)
            skips.append(x)
            x = gather_neighbour(x, pyr.pool_idx[i]).amax(dim=-2)
        x = self.mlp_mid(x)
        for j, dec in enumerate(self.dec):
            lvl = len(self.enc) - j - 1
            x = dec(torch.cat([skips[lvl], gather_points(x, pyr.interp_idx[lvl])], dim=-1))
        feat = self.mlp_out(x)
        head_in = self.dropout(feat, generator, stacked) if train else feat
        return feat, self.fc_label(head_in)


def score_points(feat, xyz, logits, neigh_idx, k_neighbours: int = 16):
    """Keypoint scores (B, N): saliency x isolation x channel ratio x gated
    semantic weight."""
    neigh_idx = neigh_idx[..., :k_neighbours]
    feat_n = feat / (torch.amax(feat, dim=(-2, -1), keepdim=True) + _EPS)
    both = gather_neighbour(torch.cat([feat_n, xyz], dim=-1), neigh_idx)
    local_max = F.softplus(feat_n - torch.mean(both[..., :-3], dim=-2))
    rel = both[..., -3:] - xyz[..., :, None, :]
    mean_dist = torch.mean(torch.linalg.vector_norm(rel, dim=-1), dim=-1)
    isolation = (mean_dist < AGGREGATION_BALL_R).to(feat.dtype)[..., None]
    channel_ratio = feat_n / (torch.amax(feat_n, dim=-1, keepdim=True) + _EPS)
    prob, label = torch.max(logits, dim=-1)
    weights = torch.tensor(LABEL_WEIGHTS, dtype=feat.dtype, device=feat.device)
    label_score = weights[label]
    label_score = label_score / (torch.amax(label_score, dim=-1, keepdim=True) + _EPS)
    prob_n = prob / (torch.amax(prob, dim=-1, keepdim=True) + _EPS)
    label_score = label_score * (prob_n > PROB_GATE)
    return torch.amax(local_max * isolation * channel_ratio * label_score[..., None], dim=-1)


def l2_normalize(f):
    return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)


def extras_of(cfg):
    return tuple(s.strip() for s in cfg.inlier_extra_feats.split(",") if s.strip())


class Network(nn.Module):
    """The network of the "feat" or "align" pipeline."""

    def __init__(self, cfg, pipeline: str):
        super().__init__()
        if pipeline not in ("feat", "align"):
            raise ValueError(f"the reference has no {pipeline!r} pipeline")
        self.cfg = cfg
        self.pipeline = pipeline
        c = cfg.out_feat_dim
        self.feat_extractor = RandLA(cfg, cfg.num_classes, cfg.feat_len)
        self.mlp_feat = MLP(c, (c, 128, c))
        self.mlp_att = MLP(4, (32, 64, 128, 256, c))
        self.mlp_proj = MLP(c, (c,))
        self.extras = extras_of(cfg)
        if pipeline == "align":
            self.inlier_model = RandLA(cfg, 1, 6 + len(self.extras))

    def pyramids(self, points_src, points_ref):
        cfg = self.cfg
        return (build_pyramid(points_src[..., :3], cfg.num_knn, cfg.sub_sampling_ratio),
                build_pyramid(points_ref[..., :3], cfg.num_knn, cfg.sub_sampling_ratio))

    def aggregate_moving(self, xyz, score, ff):
        g = self.mlp_att(torch.cat([xyz, score[..., None]], dim=-1))
        return l2_normalize(self.mlp_proj(ff + g))

    def backbone_and_scores(self, points_src, points_ref, pyr_src, pyr_ref, train=False,
                            generator=None):
        """One backbone pass over [src; ref] and the keypoint scores:
        (feat, logits, score), each stacked [src; ref] on the batch axis."""
        pts = torch.cat([points_src, points_ref], dim=0)
        pyr = concat_pyramids(pyr_src, pyr_ref)
        feat, logits = self.feat_extractor(pts, pyr, train=train, generator=generator, stacked=2)
        return feat, logits, score_points(feat, pts[..., :3], logits, pyr.neigh_idx[0])

    def forward_pair(self, points_src, points_ref, pyr_src, pyr_ref, generator=None):
        """The feat training forward: the backbone without a graph, then the
        aggregated descriptors of both clouds (num_sub <= 0: every point)."""
        b = points_src.shape[0]
        with torch.no_grad():
            feat, _, score = self.backbone_and_scores(
                points_src, points_ref, pyr_src, pyr_ref, train=True, generator=generator)
        desc_src = self.aggregate_moving(points_src[..., :3], score[:b], self.mlp_feat(feat[:b]))
        desc_ref = self.aggregate_moving(points_ref[..., :3], score[b:], self.mlp_feat(feat[b:]))
        return desc_src, desc_ref, score[:b], score[b:]

    def forward_align(self, points_src, points_ref, pyr_src, pyr_ref, num_iter: int,
                      clip_weight: bool, train: bool = False, generator=None):
        """The registration loop. Returns a dict: "feat", "logits", "score"
        (backbone, stacked [src; ref]), "transforms" (iters, B, 3, 4),
        "inlier_logits" and "pred_idx" (iters, B, N), "invalid" (B,), "pt_src"."""
        cfg = self.cfg
        b = points_src.shape[0]
        xyz_src0 = points_src[..., :3]
        xyz_ref = points_ref[..., :3].contiguous()
        with torch.no_grad():
            feat, logits, score = self.backbone_and_scores(points_src, points_ref, pyr_src,
                                                           pyr_ref)
            score_src, score_ref = score[:b], score[b:]
            fr = self.aggregate_moving(xyz_ref, score_ref, self.mlp_feat(feat[b:]))
            ff_src = self.mlp_feat(feat[:b])
        pos = self.inlier_model.pos_cache(pyr_src)
        need_ridx = "recip" in self.extras
        xyz_src = xyz_src0
        cum = se3_identity(b, xyz_src0.device)
        invalid = torch.zeros(b, dtype=torch.bool, device=xyz_src0.device)
        transforms, logits_iters, idx_iters = [], [], []
        for _ in range(num_iter):
            with torch.no_grad():
                fs = self.aggregate_moving(xyz_src, score_src, ff_src)
                if need_ridx:
                    idx, ridx = match(fs, fr, bidirectional=True)
                else:
                    idx = match(fs, fr)
                xyz_ref_new = gather_points(xyz_ref, idx)
                feats = [xyz_src, xyz_ref_new]
                if "dist" in self.extras:
                    feats.append(torch.linalg.vector_norm(fs - gather_points(fr, idx), dim=-1,
                                                          keepdim=True))
                if "recip" in self.extras:
                    back = gather_points(xyz_src0, ridx)
                    feats.append(torch.linalg.vector_norm(gather_points(back, idx) - xyz_src0,
                                                          dim=-1, keepdim=True))
                pair_feats = torch.cat(feats, dim=-1)
            _, logit = self.inlier_model(pair_feats, pyr_src, pos_cache=pos, train=train,
                                         generator=generator)
            logit = logit[..., 0]
            weights = torch.sigmoid(logit)
            if clip_weight and cfg.clip_weight_thresh > 0:
                weights = torch.where(weights < cfg.clip_weight_thresh,
                                      torch.zeros_like(weights), weights)
            r_t, bad = weighted_kabsch(xyz_src, xyz_ref_new, weights)
            xyz_src = se3_transform(r_t.detach(), xyz_src)
            cum = se3_concatenate(r_t, cum)
            invalid = invalid | bad
            transforms.append(cum)
            logits_iters.append(logit)
            idx_iters.append(idx)
        return {"feat": feat, "logits": logits, "score": score,
                "transforms": torch.stack(transforms), "inlier_logits": torch.stack(logits_iters),
                "pred_idx": torch.stack(idx_iters), "invalid": invalid, "pt_src": xyz_src0,
                "pt_ref": xyz_ref}


def check_supported(cfg) -> None:
    """The options the reference implements; raises ValueError otherwise."""
    wanted = dict(use_ppf=False, fc_norm="group", randla_skips="pre", compute_dtype="float32",
                  inlier_compute_dtype="float32", inlier_num_layers=0, inlier_num_knn=0,
                  backbone_num_knn=0, refine_stride=1, pyramid_order="shuffled",
                  absolute_pose_solve=False, mutual_check=False, num_sub=-1)
    for key, value in wanted.items():
        if getattr(cfg, key) != value:
            raise ValueError(f"the reference runs {key}={value!r}, not {getattr(cfg, key)!r}")
    if not set(extras_of(cfg)) <= {"dist", "recip"}:
        raise ValueError(f"inlier_extra_feats={cfg.inlier_extra_feats!r}")
