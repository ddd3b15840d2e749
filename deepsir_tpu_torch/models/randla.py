"""RandLA-Net encoder-decoder over an index pyramid (deepsir_tpu/models/randla.py).

Channel-last throughout. Decoder skips follow `cfg.randla_skips`: 'pre'
concatenates each level's encoder output before pooling; 'post' (the
reference's scheme) takes, for levels l >= 1, the pooled output of encoder
l-1. A network built from a truncated config (`d_out[:L]`) reads only the
first L levels of a deeper pyramid. The LocSE
positional branch is exposed as `pos_cache` so a caller that runs the same
network over the same pyramid repeatedly (the registration loop) computes it
once. In training (`train=True`) dropout at `cfg.dropout_rate` acts on the
output features before `fc_label`, as flax's `nn.Dropout` does: a kept
entry is scaled by 1 / keep, the keep mask drawn from the caller's
`torch.Generator`. Over a data-parallel `group` every rank draws the mask
of the global batch from a generator seeded alike and keeps its own rows,
so that the ranks together draw what one device draws for the whole batch;
the `fc_label` stack's batch norm then spans the group's batch too.

Every unit of the encoder and decoder (`mlp_pre`, the blocks with their
attentive poolings, `mlp_mid`, `dec`) takes `cfg.randla_norm`: GroupNorm,
DeepSIR's MLP2D, or "batch", RandLA-Net's stateless batch norm over the
whole call's batch; the heads take `cfg.fc_norm`. `cfg.label_head` picks
the head: "deepsir" (`mlp_out`, dropout, `fc_label` 64 -> 64 -> 32 ->
classes) or "randla", RandLA-Net's (Hu et al., CVPR 2020,
`RandLANet.py::inference`): `fc1` 32 -> 64 and `fc2` 64 -> 32, each with
its norm and LeakyReLU, dropout, then `fc` 32 -> classes with neither; its
`feat` is fc2's 32-channel output. The forward opens the spans
`deepsir.randla.encoder`, `.decoder` and `.head` around the three parts.

`cfg.compute_dtype` sets the Dense layers' dtype (models/layers.py); the
features and logits it returns are fp32. Under `cfg.use_ppf` the input
is not the point features but their point-pair features
(`ppf_grouping`) over the level-0 neighbours, through `mlp_pre` and a
mean over the neighbours (deepsir_tpu/models/randla.py:206-211).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.layers import (MLP, AttPooling, ConvUnit, compute_dtype, dense,
                                             leaky_relu)
from deepsir_tpu_torch.ops.gather import (gather_neighbour, max_pool_neighbours,
                                          nearest_interpolate)
from deepsir_tpu_torch.ops.pyramid import Pyramid
from deepsir_tpu_torch.utils.collectives import ProcessGroup, group_rank, group_size
from deepsir_tpu_torch.utils.profiling import span

PosEnc = Tuple[torch.Tensor, torch.Tensor]


def relative_pos_encoding(xyz: torch.Tensor, neigh_idx: torch.Tensor,
                          neigh_xyz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[dist, rel_xyz, xyz, neigh_xyz]: (..., N, 3), (..., N, K) -> (..., N, K, 10)."""
    if neigh_xyz is None:
        neigh_xyz = gather_neighbour(xyz, neigh_idx)
    center = xyz[..., :, None, :]
    rel = neigh_xyz - center
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True) + 1e-20)
    return torch.cat([dist, rel, center.expand(neigh_xyz.shape), neigh_xyz], dim=-1)


def _angle(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """The angle between v1 and v2 (..., 3) as atan2(|v1 x v2|, v1.v2); 0
    where either is zero."""
    cross = torch.linalg.cross(v1, v2, dim=-1)
    return torch.atan2(torch.linalg.vector_norm(cross, dim=-1), torch.sum(v1 * v2, dim=-1))


@torch.no_grad()
def ppf_grouping(xyz: torch.Tensor, normals: torch.Tensor,
                 neigh_idx: torch.Tensor) -> torch.Tensor:
    """Point-pair features [xyz, rel_xyz, angle(n_i, d), angle(n_j, d),
    angle(n_i, n_j), |d|] with d = xyz_j - xyz_i over the neighbours j of
    each point i: (..., N, 3), (..., N, 3), (..., N, K) -> (..., N, K, 10)
    (deepsir_tpu/models/randla.py:58-78). Input data only: no graph, so no
    norm's backward at d = 0 (each point is its own first neighbour)."""
    grouped = gather_neighbour(xyz, neigh_idx)
    di = grouped - xyz[..., :, None, :]
    ni = gather_neighbour(normals, neigh_idx)
    nr = normals[..., :, None, :].expand(di.shape)
    ppf = torch.stack([_angle(nr, di), _angle(ni, di), _angle(nr, ni),
                       torch.linalg.vector_norm(di, dim=-1)], dim=-1)
    return torch.cat([xyz[..., :, None, :].expand(grouped.shape), di, ppf], dim=-1)


class BuildingBlock(nn.Module):
    """Local feature aggregation: LocSE + two attentive poolings."""

    def __init__(self, d_out: int, dtype: Optional[torch.dtype] = None, norm: str = "group"):
        super().__init__()
        half = d_out // 2
        self.mlp1 = ConvUnit(10, half, norm=norm, dtype=dtype)
        self.att_pooling_1 = AttPooling(d_out, half, dtype=dtype, norm=norm)
        self.mlp2 = ConvUnit(half, half, norm=norm, dtype=dtype)
        self.att_pooling_2 = AttPooling(d_out, d_out, dtype=dtype, norm=norm)

    def pos_encode(self, xyz: torch.Tensor, neigh_idx: torch.Tensor) -> PosEnc:
        """The positional branch; mlp2 consumes mlp1's output (chained)."""
        p1 = self.mlp1(relative_pos_encoding(xyz, neigh_idx))
        return p1, self.mlp2(p1)

    def forward(self, xyz, feature, neigh_idx, pos: Optional[PosEnc] = None):
        if pos is not None:
            p1, p2 = pos
            f_neigh = gather_neighbour(feature, neigh_idx)
        else:
            both = gather_neighbour(torch.cat([xyz, feature], dim=-1), neigh_idx)
            p1 = self.mlp1(relative_pos_encoding(xyz, neigh_idx,
                                                 neigh_xyz=both[..., :3]))
            p2 = self.mlp2(p1)
            f_neigh = both[..., 3:]
        f_agg = self.att_pooling_1(torch.cat([f_neigh, p1], dim=-1))
        f_neigh = gather_neighbour(f_agg, neigh_idx)
        return self.att_pooling_2(torch.cat([f_neigh, p2], dim=-1))


class DilatedResBlock(nn.Module):
    def __init__(self, c_in: int, d_out: int, dtype: Optional[torch.dtype] = None,
                 norm: str = "group"):
        super().__init__()
        self.mlp1 = ConvUnit(c_in, d_out // 2, norm=norm, dtype=dtype)
        self.lfa = BuildingBlock(d_out, dtype, norm)
        self.mlp2 = ConvUnit(d_out, d_out * 2, use_act=False, norm=norm, dtype=dtype)
        self.mlp_skip = ConvUnit(c_in, d_out * 2, use_act=False, norm=norm, dtype=dtype)

    def pos_encode(self, xyz, neigh_idx) -> PosEnc:
        return self.lfa.pos_encode(xyz, neigh_idx)

    def forward(self, feature, xyz, neigh_idx, pos: Optional[PosEnc] = None):
        f_pc = self.mlp2(self.lfa(xyz, self.mlp1(feature), neigh_idx, pos=pos))
        return leaky_relu(f_pc + self.mlp_skip(feature))


class RandLA(nn.Module):
    """forward(features (B, N, F), pyramid) -> (feat (B, N, out), logits (B, N, classes))."""

    def __init__(self, cfg: ModelConfig, num_classes: int, feat_len: int):
        super().__init__()
        d = cfg.d_out
        L = len(d)
        self.post_skips = cfg.randla_skips == "post"
        self.use_ppf = cfg.use_ppf
        self.dtype = dtype = compute_dtype(cfg.compute_dtype)
        norm = cfg.randla_norm
        pre = 12 if cfg.use_ppf else 8
        self.mlp_pre = ConvUnit(10 if cfg.use_ppf else feat_len, pre, norm=norm, dtype=dtype)
        c_in = [pre] + [2 * x for x in d[:-1]]
        self.enc = nn.ModuleList(DilatedResBlock(c, x, dtype, norm) for c, x in zip(c_in, d))
        self.mlp_mid = ConvUnit(2 * d[-1], 2 * d[-1], norm=norm, dtype=dtype)
        dec = []
        x_ch = 2 * d[-1]
        for j in range(L):
            lvl = L - j - 1
            skip = 2 * d[lvl - 1] if self.post_skips and lvl > 0 else 2 * d[lvl]
            out = 2 * d[max(L - j - 2, 0)]
            dec.append(ConvUnit(skip + x_ch, out, norm=norm, dtype=dtype))
            x_ch = out
        self.dec = nn.ModuleList(dec)
        self.randla_head = cfg.label_head == "randla"
        if self.randla_head:
            self.fc1 = ConvUnit(x_ch, 64, norm=cfg.fc_norm, dtype=dtype)
            self.fc2 = ConvUnit(64, 32, norm=cfg.fc_norm, dtype=dtype)
            self.fc = ConvUnit(32, num_classes, use_norm=False, use_act=False, dtype=dtype)
        else:
            self.mlp_out = nn.Linear(x_ch, cfg.out_feat_dim, bias=False)
            self.fc_label = MLP(cfg.out_feat_dim, (cfg.out_feat_dim, 32, num_classes),
                                norm=cfg.fc_norm, dtype=dtype)
        self.dropout_rate = cfg.dropout_rate

    def pos_cache(self, pyr: Pyramid) -> Tuple[PosEnc, ...]:
        """Per-encoder-level LocSE projections (loop-invariant)."""
        return tuple(enc.pos_encode(pyr.xyz[i], pyr.neigh_idx[i])
                     for i, enc in enumerate(self.enc))

    def dropout(self, feat: torch.Tensor, generator: Optional[torch.Generator],
                group: ProcessGroup = None, stacked: int = 1):
        """flax `nn.Dropout` in training: each entry kept with probability
        1 - rate and then scaled by 1 / (1 - rate), else zeroed; the keep
        mask, of feat's shape, comes from `generator` (on feat's device).
        With a data-parallel `group` the draw is the global batch's, of
        which this rank keeps its rows: feat's batch is `stacked` blocks of
        rows (the backbone's [src; ref]), each block this rank's slice of
        the global block."""
        if self.dropout_rate == 0.0:
            return feat
        keep = 1.0 - self.dropout_rate
        rows = feat.shape[0] // stacked
        rank = group_rank(group)
        full = torch.rand((stacked, rows * group_size(group)) + feat.shape[1:],
                          generator=generator, device=feat.device, dtype=feat.dtype)
        draw = full[:, rank * rows:(rank + 1) * rows].reshape(feat.shape)
        return torch.where(draw < keep, feat / keep, torch.zeros_like(feat))

    def forward(self, features: torch.Tensor, pyr: Pyramid,
                pos_cache: Optional[Tuple[PosEnc, ...]] = None, train: bool = False,
                generator: Optional[torch.Generator] = None, group: ProcessGroup = None,
                stacked: int = 1):
        """`group`: the data-parallel group that holds the rest of the batch
        (the dropout's draw, `fc_label`'s batch norm); `stacked`: the blocks
        of rows of `features` (`dropout`)."""
        with span("deepsir.randla.encoder"):
            if self.use_ppf:
                grouped = ppf_grouping(features[..., :3], features[..., 3:6], pyr.neigh_idx[0])
                x = torch.mean(self.mlp_pre(grouped), dim=-2)       # (B, N, 12)
            else:
                x = self.mlp_pre(features)
            L = len(self.enc)
            skips = []
            for i, enc in enumerate(self.enc):
                x = enc(x, pyr.xyz[i], pyr.neigh_idx[i],
                        pos=pos_cache[i] if pos_cache else None)
                if not self.post_skips or i == 0:
                    skips.append(x)
                x = max_pool_neighbours(x, pyr.pool_idx[i])
                if self.post_skips and i < L - 1:
                    skips.append(x)                       # level i+1's skip
        with span("deepsir.randla.decoder"):
            x = self.mlp_mid(x)
            for j, dec in enumerate(self.dec):
                lvl = L - j - 1
                up = nearest_interpolate(x, pyr.interp_idx[lvl])
                x = dec(torch.cat([skips[lvl], up], dim=-1))
        with span("deepsir.randla.head"):
            if self.randla_head:
                feat = self.fc2(self.fc1(x, group), group)
                drop = self.dropout(feat, generator, group, stacked) if train else feat
                return feat, self.fc(drop)
            feat = dense(self.mlp_out, x, self.dtype).float()
            if train:
                return feat, self.fc_label(self.dropout(feat, generator, group, stacked), group)
            return feat, self.fc_label(feat, group)
