"""A cell's inputs and weights, made from `--seed`.

Clouds (the recipe of the repository's `chip_smoke.train_arrays`, on
`bench.py`'s source clouds): each source cloud is N points with xyz drawn
normal x 10 and the other channels uniform on [0, 1); its reference is a
rigid motion of it (a rotation of up to 30 degrees about a random axis and
a translation of length up to 1) plus Gaussian noise of 0.02, with its rows
reshuffled; `transform_gt` is that motion. Every seed gives the same sizes.

Weights: as flax initialises them (he-normal Dense kernels, zero biases,
unit norm scales), drawn on the device by one `torch.Generator` in one call,
in the layout of the reference network, which is the port's.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def make_pool(seed: int, pool: int, batch: int, points: int, feat_len: int) -> List[Dict]:
    """`pool` distinct host batches of `batch` pairs: dicts of `points_src`,
    `points_ref` (batch, points, feat_len) float32 and `transform_gt`
    (batch, 3, 4) float32."""
    rng = np.random.default_rng(seed)
    shape = (pool, batch, points)
    xyz = rng.normal(size=shape + (3,)).astype(np.float32) * np.float32(10.0)
    extra = rng.uniform(size=shape + (feat_len - 3,)).astype(np.float32)
    axis = rng.normal(size=(pool, batch, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = np.deg2rad(rng.uniform(0.0, 30.0, size=(pool, batch)))[..., None, None]
    k = np.zeros((pool, batch, 3, 3))
    k[..., 0, 1], k[..., 0, 2], k[..., 1, 2] = -axis[..., 2], axis[..., 1], -axis[..., 0]
    k = k - np.swapaxes(k, -1, -2)
    rot = np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)
    trans = rng.uniform(-1.0, 1.0, size=(pool, batch, 3)) / np.sqrt(3.0)
    noise = rng.normal(scale=0.02, size=shape + (3,))
    moved = (xyz @ np.swapaxes(rot, -1, -2) + trans[..., None, :] + noise).astype(np.float32)
    order = rng.permuted(np.broadcast_to(np.arange(points), shape), axis=-1)
    src = np.concatenate([xyz, extra], axis=-1)
    ref = np.take_along_axis(np.concatenate([moved, extra], axis=-1), order[..., None], axis=2)
    gt = np.concatenate([rot, trans[..., None]], axis=-1).astype(np.float32)
    return [{"points_src": np.ascontiguousarray(src[p]),
             "points_ref": np.ascontiguousarray(ref[p]),
             "transform_gt": np.ascontiguousarray(gt[p])} for p in range(pool)]


def make_weights(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for the parameter `shapes` (name -> shape): every 2-D
    weight (out, in) normal x sqrt(2 / in), all drawn in one call from a
    generator on `device` seeded with `seed`; norm scales ("...norm.weight")
    one; every other 1-D leaf zero."""
    gen = torch.Generator(device=device).manual_seed(seed & SEED_MASK)
    mats = {n: s for n, s in shapes.items() if len(s) == 2}
    flat = torch.randn(sum(s[0] * s[1] for s in mats.values()), generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            size = shape[0] * shape[1]
            out[name] = flat[offset:offset + size].view(shape) * math.sqrt(2.0 / shape[1])
            offset += size
        elif name.endswith("norm.weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
