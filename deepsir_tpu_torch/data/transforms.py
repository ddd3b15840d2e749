"""Sample transforms of the data layer, on the host
(deepsir_tpu/data/transforms.py): resamplers, jitter, the half-space crop,
the random rigid perturbations, the shuffle and the radius/height crop.

Every transform draws from the np.random.Generator it is given. The
composable ones are called as `transform(sample, rng)` on a sample dict
holding "points", or "points_src" and "points_ref" after `SplitSourceRef`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from deepsir_tpu_torch.math import rand, se3_np


def _clouds(sample: Dict) -> tuple:
    return ("points",) if "points" in sample else ("points_src", "points_ref")


class SplitSourceRef:
    """"points" moved to "points_raw", with a copy of it as each of
    "points_src" and "points_ref"."""

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        sample["points_raw"] = sample.pop("points")
        sample["points_src"] = sample["points_raw"].copy()
        sample["points_ref"] = sample["points_raw"].copy()
        return sample


def resample(rng: np.random.Generator, points: np.ndarray, k: int) -> np.ndarray:
    """Exactly k rows drawn at random: no repeats when k <= N, every row at
    least once when k > N."""
    n = points.shape[0]
    if n == k:
        return points
    if n > k:
        return points[rng.choice(n, k, replace=False)]
    return points[np.concatenate([rng.permutation(n), rng.choice(n, k - n, replace=True)])]


def fixed_resample(points: np.ndarray, k: int) -> np.ndarray:
    """Exactly k rows, deterministically: the first k, or the cloud tiled
    with its own prefix. For a cloud of k rows or more the result is a VIEW
    of `points`; callers that change it rebind instead of writing into it.
    The caller randomizes the row order upstream."""
    n = points.shape[0]
    reps, rem = k // n, k % n
    if reps == 0:
        return points[:k]
    return np.concatenate([np.tile(points, (reps, 1)), points[:rem]], axis=0)


class Resampler:
    """Each cloud resampled to exactly `num` rows (`resample`); a sample's
    "crop_proportion" (p_src[, p_ref]) scales the source's count, and the
    reference's when it has two entries, rounded up."""

    def __init__(self, num: int):
        self.num = num

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        if "points" in sample:
            sample["points"] = resample(rng, sample["points"], self.num)
            return sample
        src_size = ref_size = self.num
        prop = sample.get("crop_proportion")
        if prop:
            src_size = math.ceil(prop[0] * self.num)
            ref_size = math.ceil(prop[1] * self.num) if len(prop) > 1 else self.num
        sample["points_src"] = resample(rng, sample["points_src"], src_size)
        sample["points_ref"] = resample(rng, sample["points_ref"], ref_size)
        return sample


class RandomJitter:
    """Clipped gaussian noise on the xyz columns."""

    def __init__(self, scale: float = 0.01, clip: float = 0.05):
        self.scale = scale
        self.clip = clip

    def jitter(self, rng: np.random.Generator, pts: np.ndarray) -> np.ndarray:
        noise = np.clip(rng.normal(0.0, self.scale, size=(pts.shape[0], 3)),
                        -self.clip, self.clip)
        out = pts.copy()
        out[:, :3] = out[:, :3] + noise
        return out

    def __call__(self, sample, rng: np.random.Generator):
        """One cloud (an array) jittered, or each cloud of a sample."""
        if isinstance(sample, np.ndarray):
            return self.jitter(rng, sample)
        for key in _clouds(sample):
            sample[key] = self.jitter(rng, sample[key])
        return sample


def halfspace_crop(rng: np.random.Generator, points: np.ndarray,
                   p_keep: float) -> np.ndarray:
    """The ~p_keep of the rows on one side of a random plane through the
    centroid."""
    direction = rand.uniform_2_sphere(rng)
    dist = (points[:, :3] - np.mean(points[:, :3], axis=0)) @ direction
    if p_keep == 0.5:
        mask = dist > 0
    else:
        mask = dist > np.percentile(dist, (1.0 - p_keep) * 100)
    return points[mask]


class RandomCrop:
    """The source cloud cut to ~p_keep[0] of its rows by `halfspace_crop`,
    and the reference to ~p_keep[1] when p_keep has two entries; nothing
    when every p_keep is 1."""

    def __init__(self, p_keep: Optional[List[float]] = None):
        self.p_keep = np.array(p_keep if p_keep is not None else [0.7, 0.7], dtype=np.float32)

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        if np.all(self.p_keep == 1.0):
            return sample
        sample["points_src"] = halfspace_crop(rng, sample["points_src"], self.p_keep[0])
        if len(self.p_keep) > 1:
            sample["points_ref"] = halfspace_crop(rng, sample["points_ref"], self.p_keep[1])
        return sample


class RandomTransformSE3:
    """A random rigid motion of a cloud: a uniformly random rotation scaled
    to rot_mag degrees and a translation within trans_mag."""

    def __init__(self, rot_mag: float = 180.0, trans_mag: float = 1.0,
                 xy_rot_scale: float = 1.0):
        self.rot_mag = rot_mag
        self.trans_mag = trans_mag
        self.xy_rot_scale = xy_rot_scale

    def generate(self, rng: np.random.Generator) -> np.ndarray:
        return se3_np.to_4x4(rand.random_se3_uniform(rng, self.rot_mag, self.trans_mag))

    def transform(self, rng: np.random.Generator, pts: np.ndarray):
        """(moved pts, the 4x4 that moves them back, the 4x4 applied)."""
        igt = self.generate(rng)
        return se3_np.apply_to_cloud(igt, pts), se3_np.inverse(igt), igt

    def __call__(self, sample, rng: np.random.Generator):
        """One cloud (an array): `transform`'s triple. A sample: "points"
        moved, or "points_src" moved and "transform_gt" (3, 4) set to the
        motion back."""
        if isinstance(sample, np.ndarray):
            return self.transform(rng, sample)
        if "points" in sample:
            sample["points"], _, _ = self.transform(rng, sample["points"])
        else:
            sample["points_src"], gt, _ = self.transform(rng, sample["points_src"])
            sample["transform_gt"] = gt[:3, :]
        return sample


class RandomTransformSE3Euler(RandomTransformSE3):
    """Per-axis Euler angles, x and y scaled by xy_rot_scale."""

    def generate(self, rng: np.random.Generator) -> np.ndarray:
        return rand.random_se3_euler(rng, self.rot_mag, self.trans_mag, self.xy_rot_scale)


class RandomRotatorZ(RandomTransformSE3):
    """A random rotation about the gravity axis."""

    def __init__(self, rot_mag: float = 360.0):
        super().__init__(rot_mag=rot_mag)

    def generate(self, rng: np.random.Generator) -> np.ndarray:
        return rand.random_rotation_z(rng, self.rot_mag)


class ShufflePoints:
    """The rows of each cloud in a random order."""

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        for key in _clouds(sample):
            sample[key] = sample[key][rng.permutation(len(sample[key]))]
        return sample


def process_point_cloud(cloud: np.ndarray, r_min: float = 0.0, r_max: float = 50.0,
                        z_min: float = -3.0, z_max: float = 10.0) -> np.ndarray:
    """The rows with r_min < |xyz| <= r_max and z_min <= z <= z_max."""
    r2 = np.sum(cloud[:, :3] ** 2, axis=1)
    mask = (r2 <= r_max ** 2) & (r2 > r_min ** 2) & \
        (cloud[:, 2] >= z_min) & (cloud[:, 2] <= z_max)
    return cloud[mask]
