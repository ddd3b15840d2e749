"""Sample transforms of the data layer, on the host
(deepsir_tpu/data/transforms.py): resamplers, jitter, the half-space crop,
the random rigid perturbations and the radius/height crop.

Every transform draws from the np.random.Generator it is given.
"""
from __future__ import annotations

import numpy as np

from deepsir_tpu_torch.math import rand, se3_np


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


def process_point_cloud(cloud: np.ndarray, r_min: float = 0.0, r_max: float = 50.0,
                        z_min: float = -3.0, z_max: float = 10.0) -> np.ndarray:
    """The rows with r_min < |xyz| <= r_max and z_min <= z <= z_max."""
    r2 = np.sum(cloud[:, :3] ** 2, axis=1)
    mask = (r2 <= r_max ** 2) & (r2 > r_min ** 2) & \
        (cloud[:, 2] >= z_min) & (cloud[:, 2] <= z_max)
    return cloud[mask]
