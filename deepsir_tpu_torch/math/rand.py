"""Random rigid transforms for the data layer's augmentations, on the host
(deepsir_tpu/math/rand.py).

Every function draws from the np.random.Generator it is given, so a sample
is a function of its generator's seed alone: the loader seeds one per
sample, and the port's batches equal the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def uniform_2_sphere(rng: np.random.Generator, num: int | None = None) -> np.ndarray:
    """Uniform direction(s) on the unit sphere: (3,), or (num, 3)."""
    if num is not None:
        phi = rng.uniform(0.0, 2 * np.pi, num)
        cos_theta = rng.uniform(-1.0, 1.0, num)
    else:
        phi = rng.uniform(0.0, 2 * np.pi)
        cos_theta = rng.uniform(-1.0, 1.0)
    theta = np.arccos(cos_theta)
    return np.stack((np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                     np.cos(theta)), axis=-1)


def random_rotation_z(rng: np.random.Generator, rot_mag_deg: float = 360.0) -> np.ndarray:
    """A rotation about z by an angle uniform in [0, rot_mag_deg), 4x4."""
    deg = rng.random() * rot_mag_deg
    mat = np.identity(4, dtype=np.float64)
    mat[:3, :3] = Rotation.from_euler("z", deg, degrees=True).as_matrix()
    return mat


def random_se3_euler(rng: np.random.Generator, rot_mag: float = 45.0,
                     trans_mag: float = 2.0, xy_rot_scale: float = 1.0) -> np.ndarray:
    """Rx Ry Rz with angles uniform in [0, pi * rot_mag / 180) (x and y
    scaled by xy_rot_scale) and a translation uniform in [-trans_mag,
    trans_mag]^3, 4x4."""
    anglex = rng.uniform() * np.pi * rot_mag / 180.0 * xy_rot_scale
    angley = rng.uniform() * np.pi * rot_mag / 180.0 * xy_rot_scale
    anglez = rng.uniform() * np.pi * rot_mag / 180.0
    cx, cy, cz = np.cos([anglex, angley, anglez])
    sx, sy, sz = np.sin([anglex, angley, anglez])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    mat = np.identity(4, dtype=np.float64)
    mat[:3, :3] = rx @ ry @ rz
    mat[:3, 3] = rng.uniform(-trans_mag, trans_mag, 3)
    return mat


def random_se3_uniform(rng: np.random.Generator, rot_mag: float = 180.0,
                       trans_mag: float = 1.0) -> np.ndarray:
    """A uniformly random rotation with its axis-angle scaled by
    rot_mag / 180 and a translation uniform in [-trans_mag, trans_mag]^3,
    (3, 4) float32."""
    rand_rot = Rotation.random(random_state=np.random.RandomState(rng.integers(2**31)))
    rot = Rotation.from_rotvec(rand_rot.as_rotvec() * (rot_mag / 180.0)).as_matrix()
    trans = rng.uniform(-trans_mag, trans_mag, 3)
    return np.concatenate((rot, trans[:, None]), axis=1).astype(np.float32)


def sample_random_trans(rng: np.random.Generator, pcd: np.ndarray,
                        rotation_range_deg: float = 0.0) -> np.ndarray:
    """A rotation by an angle uniform in [-range/2, range/2] about a random
    axis, with the translation that takes the cloud's centroid to the
    origin, 4x4."""
    axis = rng.random(3) - 0.5
    axis = axis / np.linalg.norm(axis)
    theta = rotation_range_deg * np.pi / 180.0 * (rng.random() - 0.5)
    rot = Rotation.from_rotvec(axis * theta).as_matrix()
    mat = np.eye(4)
    mat[:3, :3] = rot
    mat[:3, 3] = rot @ (-np.mean(pcd[:, :3], axis=0))
    return mat
