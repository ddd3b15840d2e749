"""The reference training step in plain PyTorch: pyramids, the pipeline's
loss, backward, the skip guard and Adam on the trained groups at the
staircase learning rate.

A frozen copy of the plain path of the port's `training.train_step` on one
device (Adam written out: betas 0.9 / 0.999, eps 1e-8 outside the square
root). Nothing here imports the port.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.losses import det_des_loss, scan_alignment_loss
from benchmark.reference.network import Network

TRAINED = {"feat": ("mlp_feat", "mlp_att", "mlp_proj"), "align": ("inlier_model",)}


def trained_names(model: Network) -> List[str]:
    """The names of the parameters `model.pipeline` trains, in order."""
    groups = TRAINED[model.pipeline]
    return [n for n, _ in model.named_parameters() if n.split(".")[0] in groups]


def lr_at(count: int, train, steps_per_epoch: int) -> float:
    """The staircase-decayed learning rate after `count` applied updates, in fp32."""
    f32 = np.float32
    steps = max(1, train.lr_decay_epoch * steps_per_epoch)
    if count <= 0:
        value = f32(train.lr)
    else:
        value = f32(train.lr) * np.power(f32(train.lr_decay_ratio),
                                         np.floor(f32(count) / f32(steps)), dtype=f32)
    clip = max if train.lr_decay_ratio < 1.0 else min
    return float(clip(f32(value), f32(train.lr_clip)))


def _tensor(x, device):
    return torch.as_tensor(np.ascontiguousarray(x), device=device).to(torch.float32)


class Trainer:
    """The reference's model, Adam state and count."""

    def __init__(self, model: Network, loss, train, steps_per_epoch: int, num_iter: int):
        if loss.wt_pose_loss or loss.overlap_det_mask:
            raise ValueError("the reference has no pose term and no overlap mask")
        self.model, self.loss, self.train = model, loss, train
        self.steps_per_epoch, self.num_iter = steps_per_epoch, num_iter
        self.names = trained_names(model)
        params = dict(model.named_parameters())
        self.params = [params[n] for n in self.names]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def loss_terms(self, arrays, generator) -> Dict[str, torch.Tensor]:
        model = self.model
        device = self.params[0].device
        src, ref = (_tensor(arrays[k], device) for k in ("points_src", "points_ref"))
        gt = _tensor(arrays["transform_gt"], device)
        pyr_src, pyr_ref = model.pyramids(src, ref)
        if model.pipeline == "feat":
            d_src, d_ref, _, s_ref = model.forward_pair(src, ref, pyr_src, pyr_ref, generator)
            return det_des_loss(d_src, d_ref, src[..., :3], ref[..., :3], s_ref, gt, self.loss)
        out = model.forward_align(src, ref, pyr_src, pyr_ref, self.num_iter, clip_weight=False,
                                  train=True, generator=generator)
        terms = scan_alignment_loss(out, gt, self.loss)
        terms["invalid"] = out["invalid"].any()
        return terms

    def step(self, arrays, generator) -> Dict:
        """One step; returns the loss terms (floats), the grads (by name,
        detached) and whether the update was applied."""
        for p in self.params:
            p.grad = None
        terms = self.loss_terms(arrays, generator)
        invalid = terms.pop("invalid", torch.zeros((), dtype=torch.bool))
        terms["total"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        ok = bool(torch.isfinite(terms["total"].detach()) & ~invalid.to(terms["total"].device)
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
        return {"terms": {k: float(v.detach()) for k, v in terms.items()},
                "grads": dict(zip(self.names, (g.detach() for g in grads))), "applied": ok}
