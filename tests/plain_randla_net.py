"""RandLA-Net's semantic segmentation step in plain PyTorch: the forward, the
class-weighted cross entropy and one Adam step, in float32 with TF32 off
(both switches are set when this module is imported).

The network is RandLA-Net (Hu et al., "RandLA-Net: Efficient Semantic
Segmentation of Large-Scale Point Clouds", CVPR 2020;
https://github.com/QingyongHu/RandLA-Net, `RandLANet.py::inference` at
`helper_tool.py::ConfigSemanticKITTI`): fc0 (Dense to 8), four dilated
residual blocks (LocSE's 10-channel relative position encoding, two
attentive poolings, a shortcut), each followed by random sampling as a max
over the sub-points' neighbours; `decoder_0`; four decoder stages of
nearest upsampling, concatenation with the encoder's skip and a 1x1 Dense
to the skip's width; the head fc1 (to 64), fc2 (to 32), dropout, fc (to
the classes, no norm, no activation). Every other unit is Dense, batch
norm and LeakyReLU 0.2. The loss is cross entropy weighted by 1 / (class
frequency + 0.02) over SemanticKITTI's class counts, the points labelled 0
left out.

No kernels and nothing of the program under test: torch and numpy only.
The index pyramid is built here: per level the k nearest points of a
cloud by squared distance, elementwise and summed in coordinate order,
then `topk` over one int64 key of the distance's bits and the index
(ascending, ties to the lowest index); the first N / r points of each
shuffled cloud as the next level; each point's nearest next-level point
for the upsampling. Parameters are named as in `deepsir_tpu_torch`'s label
network (`feat_extractor.mlp_pre.dense.weight`, ...), so that one state
dict loads into both.

Departures from the published network and step:
- batch norm's epsilon is 1e-5, as the port's `batch_norm` has it (the
  published TF code's value is not restated here);
- batch norm is stateless: the statistics of the call's batch in training
  and in inference alike, no running averages;
- the loss: a batch holds pairs of clouds (the sources, then the
  references), each half's loss is sum(w nll) / sum(w) over its valid
  points, and the two are added; RandLA-Net's is the mean of w nll over
  the valid points of the whole batch;
- the LocSE distance is taken without an epsilon under its square root, as
  published; the port adds 1e-20 there;
- dropout keeps an entry where a `torch.rand` draw from the caller's
  generator, of shape (2, B, N, 32) over the batch's two halves, is below
  the keep rate, and scales it by 1 / keep;
- Adam: betas 0.9 / 0.999 and eps 1e-8 added to the bias-corrected root
  (Kingma and Ba's form, as optax and torch take it; TF's AdamOptimizer
  adds its epsilon before the bias correction), at the learning rate
  decayed in steps by `lr_decay_ratio` every `lr_decay_epoch` epochs.

Beside the published layout, two of the port's options, for the tests
that hold the port's other layouts: `randla_norm="group"` (GroupNorm with
8 groups from 64 channels, else 4, per sample, as DeepSIR's MLP2D) and
`label_head="deepsir"` (a 64-channel bias-free Dense, dropout, then
64 -> 32 -> classes under `fc_norm`). The decoder's skips are the
published ones (the port's `randla_skips="post"`) only.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LEAKY_SLOPE = 0.2
NORM_EPS = 1e-5
KNN_TILE = 1 << 26                 # distance entries of one KNN tile
# SemanticKITTI's points per class (helper_tool.py::DataProcessing.get_class_weights)
NUM_PER_CLASS = np.array([
    55437630, 320797, 541736, 2578735, 3274484, 552662, 184064, 78858,
    240942562, 17294618, 170599734, 6369672, 230413074, 101130274, 476491114,
    9833174, 129609852, 4506626, 1168181], dtype=np.float64)
CLASS_WEIGHTS = (1.0 / (NUM_PER_CLASS / NUM_PER_CLASS.sum() + 0.02)).astype(np.float32)


# ---------------------------------------------------------------- the pyramid

def knn(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) float32 -> the k nearest ref rows (B, N, k)
    int64, ascending, ties to the lowest index."""
    b, n, d = query.shape
    m = ref.shape[1]
    if not 1 <= k <= m:
        raise ValueError(f"k={k} neighbours among {m} points")
    col = torch.arange(m, device=ref.device)
    rows = max(1, KNN_TILE // (b * m))
    parts = []
    for s in range(0, n, rows):
        q = query[:, s:s + rows, None]
        acc = None
        for c in range(d):
            diff = q[..., c] - ref[:, None, :, c]
            sq = diff * diff
            acc = sq if acc is None else acc + sq
        key = (acc.view(torch.int32).to(torch.int64) << 32) | col
        parts.append(torch.topk(key, k, dim=-1, largest=False).values & 0xFFFFFFFF)
    return torch.cat(parts, dim=1)


class Pyramid(NamedTuple):
    xyz: List[torch.Tensor]          # (B, N_l, 3)
    neigh: List[torch.Tensor]        # (B, N_l, K)
    pool: List[torch.Tensor]         # (B, N_{l+1}, K)
    interp: List[torch.Tensor]       # (B, N_l)


def build_pyramid(xyz: torch.Tensor, num_knn: int, ratios) -> Pyramid:
    """The index pyramid of shuffled clouds (B, N, 3), searched in float32;
    each level's points in xyz's own dtype."""
    out = Pyramid([], [], [], [])
    pc = xyz.float().contiguous()
    for r in ratios:
        n_next = pc.shape[1] // r
        neigh = knn(pc, pc, num_knn)
        sub = pc[:, :n_next].contiguous()
        out.xyz.append(xyz[:, :pc.shape[1]])
        out.neigh.append(neigh)
        out.pool.append(neigh[:, :n_next])
        out.interp.append(knn(pc, sub, 1)[..., 0])
        pc = sub
    return out


def gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, N, C); idx (B, ...) -> (B, ..., C)."""
    batch = torch.arange(values.shape[0], device=idx.device)
    return values[batch.view(-1, *([1] * (idx.dim() - 1))), idx]


# ---------------------------------------------------------------- the network

class GroupNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.groups = 8 if channels >= 64 else 4
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xg = x.reshape(b, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
        return ((xg - mean) / torch.sqrt(var + NORM_EPS)).reshape(x.shape) * self.weight \
            + self.bias


class Unit(nn.Module):
    """Dense, then the norm ("batch", "group" or "none"), then LeakyReLU."""

    def __init__(self, c_in: int, c_out: int, norm: str, act: bool = True):
        super().__init__()
        self.dense = nn.Linear(c_in, c_out)
        self.kind, self.act = norm, act
        if norm == "group":
            self.norm = GroupNorm(c_out)
        elif norm == "batch":
            self.scale = nn.Parameter(torch.ones(c_out))
            self.bias = nn.Parameter(torch.zeros(c_out))
        elif norm != "none":
            raise ValueError(f"norm {norm!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense(x)
        if self.kind == "group":
            x = self.norm(x)
        elif self.kind == "batch":
            axes = tuple(range(x.dim() - 1))
            var, mean = torch.var_mean(x, dim=axes, unbiased=False, keepdim=True)
            x = (x - mean) / torch.sqrt(var + NORM_EPS) * self.scale + self.bias
        return F.leaky_relu(x, LEAKY_SLOPE) if self.act else x


class AttPooling(nn.Module):
    def __init__(self, c_in: int, d_out: int, norm: str):
        super().__init__()
        self.dense = nn.Linear(c_in, c_in, bias=False)
        self.unit = Unit(c_in, d_out, norm)

    def forward(self, feature_set: torch.Tensor) -> torch.Tensor:
        scores = torch.softmax(self.dense(feature_set), dim=-2)      # over the neighbours
        return self.unit(torch.sum(feature_set * scores, dim=-2))


class BuildingBlock(nn.Module):
    def __init__(self, d_out: int, norm: str):
        super().__init__()
        self.mlp1 = Unit(10, d_out // 2, norm)
        self.att_pooling_1 = AttPooling(d_out, d_out // 2, norm)
        self.mlp2 = Unit(d_out // 2, d_out // 2, norm)
        self.att_pooling_2 = AttPooling(d_out, d_out, norm)

    def forward(self, xyz, feature, neigh):
        neigh_xyz = gather(xyz, neigh)
        center = xyz[:, :, None, :].expand(neigh_xyz.shape)
        rel = neigh_xyz - center
        dist = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True))
        f_xyz = self.mlp1(torch.cat([dist, rel, center, neigh_xyz], dim=-1))
        agg = self.att_pooling_1(torch.cat([gather(feature, neigh), f_xyz], dim=-1))
        f_xyz = self.mlp2(f_xyz)
        return self.att_pooling_2(torch.cat([gather(agg, neigh), f_xyz], dim=-1))


class DilatedResBlock(nn.Module):
    def __init__(self, c_in: int, d_out: int, norm: str):
        super().__init__()
        self.mlp1 = Unit(c_in, d_out // 2, norm)
        self.lfa = BuildingBlock(d_out, norm)
        self.mlp2 = Unit(d_out, 2 * d_out, norm, act=False)
        self.mlp_skip = Unit(c_in, 2 * d_out, norm, act=False)

    def forward(self, feature, xyz, neigh):
        f = self.mlp2(self.lfa(xyz, self.mlp1(feature), neigh))
        return F.leaky_relu(f + self.mlp_skip(feature), LEAKY_SLOPE)


class MLP(nn.Module):
    def __init__(self, c_in: int, widths, norm: str):
        super().__init__()
        last = len(widths) - 1
        self.units = nn.ModuleList(
            Unit(c, w, norm if i < last else "none", act=i < last)
            for i, (c, w) in enumerate(zip([c_in] + list(widths[:-1]), widths)))

    def forward(self, x):
        for unit in self.units:
            x = unit(x)
        return x


class RandLANet(nn.Module):
    """forward(features (B, N, F), pyramid) -> (features before the
    classifier (B, N, 32 or out_feat_dim), logits (B, N, classes))."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.randla_skips != "post":
            raise ValueError("the published decoder's skips only (randla_skips='post')")
        d, norm = list(cfg.d_out), cfg.randla_norm
        self.mlp_pre = Unit(cfg.feat_len, 8, norm)
        self.enc = nn.ModuleList(DilatedResBlock(c, x, norm)
                                 for c, x in zip([8] + [2 * x for x in d[:-1]], d))
        self.mlp_mid = Unit(2 * d[-1], 2 * d[-1], norm)
        dec, x_ch = [], 2 * d[-1]
        for j in range(len(d)):
            out = 2 * d[max(len(d) - j - 2, 0)]
            dec.append(Unit(out + x_ch, out, norm))       # the skip is `out` wide
            x_ch = out
        self.dec = nn.ModuleList(dec)
        self.published_head = cfg.label_head == "randla"
        if self.published_head:
            self.fc1 = Unit(x_ch, 64, cfg.fc_norm)
            self.fc2 = Unit(64, 32, cfg.fc_norm)
            self.fc = Unit(32, cfg.num_classes, "none", act=False)
        else:
            self.mlp_out = nn.Linear(x_ch, cfg.out_feat_dim, bias=False)
            self.fc_label = MLP(cfg.out_feat_dim, (cfg.out_feat_dim, 32, cfg.num_classes),
                                cfg.fc_norm)
        self.keep = 1.0 - cfg.dropout_rate

    def dropout(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if self.keep == 1.0:
            return x
        draw = torch.rand((2, x.shape[0] // 2) + x.shape[1:], generator=generator,
                          device=x.device).reshape(x.shape)          # float32 draws
        return torch.where(draw < self.keep, x / self.keep, torch.zeros_like(x))

    def forward(self, features: torch.Tensor, pyr: Pyramid, train: bool = False,
                generator: torch.Generator = None):
        x = self.mlp_pre(features)
        skips = []
        for i, enc in enumerate(self.enc):
            x = enc(x, pyr.xyz[i], pyr.neigh[i])
            if i == 0:
                skips.append(x)
            x = gather(x, pyr.pool[i]).amax(dim=-2)            # random sampling
            if i < len(self.enc) - 1:
                skips.append(x)
        x = self.mlp_mid(x)
        for j, dec in enumerate(self.dec):
            lvl = len(self.dec) - j - 1
            x = dec(torch.cat([skips[lvl], gather(x, pyr.interp[lvl])], dim=-1))
        if self.published_head:
            feat = self.fc2(self.fc1(x))
            return feat, self.fc(self.dropout(feat, generator) if train else feat)
        feat = self.mlp_out(x)
        return feat, self.fc_label(self.dropout(feat, generator) if train else feat)


class SegmentationNet(nn.Module):
    """The label network: the RandLA net as `feat_extractor`."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.feat_extractor = RandLANet(cfg)


# ---------------------------------------------------------------- the step

def semantic_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """sum(w nll) / sum(w) over the points labelled 1..classes (0 left out)."""
    valid = labels > 0
    target = torch.clamp(labels - 1, 0, logits.shape[-1] - 1)
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, target[..., None])[..., 0]
    weights = torch.as_tensor(CLASS_WEIGHTS, device=logits.device)[target] * valid
    return torch.sum(nll * weights) / torch.sum(weights)


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), device=device).to(dtype)


def forward_batch(model: SegmentationNet, arrays: Dict, train: bool = False,
                  generator: torch.Generator = None):
    """A host batch of pairs (`points_src`, `points_ref` (B, N, F), and for
    the loss `labels_src`, `labels_ref` (B, N)) through the network, the
    sources stacked before the references: (features, logits (2B, N,
    classes), the loss or None without labels), in the parameters' dtype."""
    param = next(model.parameters())
    device = param.device
    pts = torch.cat([_tensor(arrays["points_src"], device, param.dtype),
                     _tensor(arrays["points_ref"], device, param.dtype)], dim=0)
    cfg = model.cfg
    pyr = build_pyramid(pts[..., :3], cfg.num_knn, cfg.sub_sampling_ratio)
    feat, logits = model.feat_extractor(pts, pyr, train, generator)
    if "labels_src" not in arrays:
        return feat, logits, None
    b = pts.shape[0] // 2
    loss = sum(semantic_loss(lg, _tensor(arrays[key], device, torch.int64))
               for lg, key in ((logits[:b], "labels_src"), (logits[b:], "labels_ref")))
    return feat, logits, loss


def lr_at(count: int, train, steps_per_epoch: int) -> float:
    """The learning rate after `count` applied updates, decayed in steps, in fp32."""
    f32 = np.float32
    steps = max(1, train.lr_decay_epoch * steps_per_epoch)
    value = f32(train.lr)
    if count > 0:
        value = value * np.power(f32(train.lr_decay_ratio), np.floor(f32(count) / f32(steps)),
                                 dtype=f32)
    clip = max if train.lr_decay_ratio < 1.0 else min
    return float(clip(f32(value), f32(train.lr_clip)))


class Trainer:
    """The label step on every parameter of the network: its Adam state and
    count."""

    def __init__(self, model: SegmentationNet, train, steps_per_epoch: int):
        self.model, self.train, self.steps_per_epoch = model, train, steps_per_epoch
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def step(self, arrays: Dict, generator: torch.Generator) -> Dict:
        """One step; returns the loss ("terms": {"total": float}), the grads
        (by name, detached) and whether the update was applied (the loss and
        every gradient finite)."""
        for p in self.params:
            p.grad = None
        _, _, loss = forward_batch(self.model, arrays, True, generator)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        ok = bool(torch.isfinite(loss.detach())
                  & torch.stack([torch.isfinite(g).all() for g in grads]).all())
        lr = lr_at(self.count, self.train, self.steps_per_epoch)
        if ok:
            self.count += 1
            b1, b2, eps = 0.9, 0.999, 1e-8
            c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
            with torch.no_grad():
                for p, g, m, v in zip(self.params, grads, self.m, self.v):
                    m.mul_(b1).add_(g, alpha=1.0 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))
        return {"terms": {"total": float(loss.detach())},
                "grads": dict(zip(self.names, (g.detach() for g in grads))), "applied": ok}
