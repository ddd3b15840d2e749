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
`torch.Generator`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.layers import MLP, AttPooling, ConvUnit, leaky_relu
from deepsir_tpu_torch.ops.gather import (gather_neighbour, max_pool_neighbours,
                                          nearest_interpolate)
from deepsir_tpu_torch.ops.pyramid import Pyramid

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


class BuildingBlock(nn.Module):
    """Local feature aggregation: LocSE + two attentive poolings."""

    def __init__(self, d_out: int):
        super().__init__()
        half = d_out // 2
        self.mlp1 = ConvUnit(10, half)
        self.att_pooling_1 = AttPooling(d_out, half)
        self.mlp2 = ConvUnit(half, half)
        self.att_pooling_2 = AttPooling(d_out, d_out)

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
    def __init__(self, c_in: int, d_out: int):
        super().__init__()
        self.mlp1 = ConvUnit(c_in, d_out // 2)
        self.lfa = BuildingBlock(d_out)
        self.mlp2 = ConvUnit(d_out, d_out * 2, use_act=False)
        self.mlp_skip = ConvUnit(c_in, d_out * 2, use_act=False)

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
        self.mlp_pre = ConvUnit(feat_len, 8)
        c_in = [8] + [2 * x for x in d[:-1]]
        self.enc = nn.ModuleList(DilatedResBlock(c, x) for c, x in zip(c_in, d))
        self.mlp_mid = ConvUnit(2 * d[-1], 2 * d[-1])
        dec = []
        x_ch = 2 * d[-1]
        for j in range(L):
            lvl = L - j - 1
            skip = 2 * d[lvl - 1] if self.post_skips and lvl > 0 else 2 * d[lvl]
            out = 2 * d[max(L - j - 2, 0)]
            dec.append(ConvUnit(skip + x_ch, out))
            x_ch = out
        self.dec = nn.ModuleList(dec)
        self.mlp_out = nn.Linear(x_ch, cfg.out_feat_dim, bias=False)
        self.fc_label = MLP(cfg.out_feat_dim, (cfg.out_feat_dim, 32, num_classes),
                            norm=cfg.fc_norm)
        self.dropout_rate = cfg.dropout_rate

    def pos_cache(self, pyr: Pyramid) -> Tuple[PosEnc, ...]:
        """Per-encoder-level LocSE projections (loop-invariant)."""
        return tuple(enc.pos_encode(pyr.xyz[i], pyr.neigh_idx[i])
                     for i, enc in enumerate(self.enc))

    def dropout(self, feat: torch.Tensor, generator: Optional[torch.Generator]):
        """flax `nn.Dropout` in training: each entry kept with probability
        1 - rate and then scaled by 1 / (1 - rate), else zeroed; the keep
        mask, of feat's shape, comes from `generator` (on feat's device)."""
        if self.dropout_rate == 0.0:
            return feat
        keep = 1.0 - self.dropout_rate
        draw = torch.rand(feat.shape, generator=generator, device=feat.device,
                          dtype=feat.dtype)
        return torch.where(draw < keep, feat / keep, torch.zeros_like(feat))

    def forward(self, features: torch.Tensor, pyr: Pyramid,
                pos_cache: Optional[Tuple[PosEnc, ...]] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
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
        x = self.mlp_mid(x)
        for j, dec in enumerate(self.dec):
            lvl = L - j - 1
            up = nearest_interpolate(x, pyr.interp_idx[lvl])
            x = dec(torch.cat([skips[lvl], up], dim=-1))
        feat = self.mlp_out(x)
        return feat, self.fc_label(self.dropout(feat, generator) if train else feat)
