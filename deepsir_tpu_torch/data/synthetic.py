"""Synthetic rigid pairs (deepsir_tpu/data/synthetic.py): clouds of gaussian
clusters with a pseudo-label per point, each pair the same cloud under a
random rigid motion, with optional noise and half-space crops. Needs no
dataset on disk; every pair is a function of (split, index) alone.
"""
from __future__ import annotations

import numpy as np

from deepsir_tpu_torch.config import Config
from deepsir_tpu_torch.data.base import PairDataset
from deepsir_tpu_torch.data.transforms import halfspace_crop
from deepsir_tpu_torch.math import rand, se3_np


def make_structured_cloud(rng: np.random.Generator, num_points: int,
                          num_clusters: int = 40, extent: float = 10.0) -> np.ndarray:
    """A mixture-of-clusters cloud (N, 4): xyz and a label in 1..19 (the
    SemanticKITTI class range) from the cluster's spatial scale, which is
    invariant to rigid motion and learnable from local geometry."""
    centers = rng.uniform(-extent, extent, size=(num_clusters, 3))
    scales = rng.uniform(0.1, 1.0, size=(num_clusters, 1))
    assign = rng.integers(0, num_clusters, size=num_points)
    pts = centers[assign] + rng.normal(size=(num_points, 3)) * scales[assign]
    labels = 1 + np.minimum((scales[assign, 0] - 0.1) / 0.9 * 19, 18).astype(int)
    return np.concatenate([pts, labels[:, None]], axis=1).astype(np.float32)


class SyntheticPairs(PairDataset):
    """Pairs of one synthetic cloud related by a random rigid motion."""
    has_labels = True

    def __init__(self, cfg: Config, split: str = "train", size: int = None,
                 noise: float = 0.01, p_keep: float = 1.0, offset: int = 0):
        super().__init__(cfg, split)
        if size is None:
            size = {"train": 256, "val": 64, "test": 32}.get(split, 64)
        self.size = size
        # shifts the (seed_base, idx) stream, for an independent slice
        self.offset = offset
        self.seed_base = {"train": 977, "val": 1977, "test": 2977}.get(split, 977)
        self.noise = noise
        self.p_keep = p_keep
        self.label_column = self.feat_len
        if split == "test":
            self.random_rotation = False
            self.random_jitter = False

    def __len__(self) -> int:
        return self.size

    def get_pair(self, idx: int):
        idx = idx + self.offset
        rng = np.random.default_rng((self.seed_base, idx))
        cloud = make_structured_cloud(rng, max(self.num_points, 2048))   # xyz + label
        gt = rand.random_se3_euler(rng, self.cfg.data.rot_mag, self.cfg.data.trans_mag,
                                   self.cfg.data.xy_rot_scale)
        ref = np.concatenate([se3_np.transform(gt, cloud[:, :3]), cloud[:, 3:]], axis=1)
        src = cloud.copy()
        if self.p_keep < 1.0:
            # train: a keep fraction per cloud uniform in [p_keep, 1] (an
            # overlap curriculum); val and test: p_keep itself
            if self.split == "train":
                keep_src = rng.uniform(self.p_keep, 1.0)
                keep_ref = rng.uniform(self.p_keep, 1.0)
            else:
                keep_src = keep_ref = self.p_keep
            if keep_src < 1.0:
                src = halfspace_crop(rng, src, keep_src)
            if keep_ref < 1.0:
                ref = halfspace_crop(rng, ref, keep_ref)
        if self.noise > 0:
            src[:, :3] += rng.normal(scale=self.noise, size=(len(src), 3)).astype(np.float32)
            ref[:, :3] += rng.normal(scale=self.noise, size=(len(ref), 3)).astype(np.float32)
        src = src[rng.permutation(len(src))]
        ref = ref[rng.permutation(len(ref))]

        def layout(c):
            # xyz, zeros up to feat_len, the label last
            pad = np.zeros((len(c), max(self.feat_len - 3, 0)), np.float32)
            return np.concatenate([c[:, :3], pad, c[:, 3:]], axis=1)

        meta = {"seq": 0, "id_src": idx, "id_ref": idx}
        return layout(src).astype(np.float32), layout(ref).astype(np.float32), gt, meta
