"""SE(3) helpers on numpy arrays, for the host side: the eval harness and
the data layer (deepsir_tpu/math/se3_np.py).

Transforms are ([B,] 3/4, 4) matrices [R | t]; points are ([B,] N, 3).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

_BOTTOM = np.array([[0.0, 0.0, 0.0, 1.0]])


def identity() -> np.ndarray:
    return np.eye(3, 4)


def transform(g: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply the transform g to the first three channels of pts."""
    rot = g[..., :3, :3]
    trans = g[..., :3, 3]
    return pts[..., :3] @ np.swapaxes(rot, -1, -2) + trans[..., None, :]


def _with_bottom(out: np.ndarray, like: np.ndarray) -> np.ndarray:
    """out (..., 3, 4), with the row [0, 0, 0, 1] below it where `like` has one."""
    if like.shape[-2] != 4:
        return out
    return np.concatenate([out, np.broadcast_to(_BOTTOM, like.shape[:-2] + (1, 4))], axis=-2)


def inverse(g: np.ndarray) -> np.ndarray:
    inv_rot = np.swapaxes(g[..., :3, :3], -1, -2)
    inv = np.concatenate([inv_rot, inv_rot @ -g[..., :3, 3][..., None]], axis=-1)
    return _with_bottom(inv, g)


def concatenate(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b, shaped as a."""
    ra, ta = a[..., :3, :3], a[..., :3, 3]
    rb, tb = b[..., :3, :3], b[..., :3, 3]
    out = np.concatenate([ra @ rb, ra @ tb[..., None] + ta[..., None]], axis=-1)
    return _with_bottom(out, a)


def to_4x4(g: np.ndarray) -> np.ndarray:
    if g.shape[-2] == 4:
        return g
    return np.concatenate([g, np.broadcast_to(_BOTTOM, g.shape[:-2] + (1, 4))], axis=-2)


def apply_to_cloud(trans_mat: np.ndarray, p0: np.ndarray) -> np.ndarray:
    """Transform a cloud (N, C) whose columns are xyz, then optionally
    normals (columns 3:6, rotated when C >= 6), then any other channels,
    which ride along unchanged."""
    p1 = transform(trans_mat, p0[:, :3])
    if p0.shape[1] >= 6:
        normals = p0[:, 3:6] @ trans_mat[:3, :3].T
        return np.concatenate((p1, normals, p0[:, 6:]), axis=-1)
    if p0.shape[1] > 3:
        return np.concatenate((p1, p0[:, 3:]), axis=-1)
    return p1


def quat2mat(q: np.ndarray) -> np.ndarray:
    """Rotation matrix from a quaternion (w, x, y, z), not necessarily unit;
    a near-zero quaternion gives the identity."""
    w, x, y, z = np.asarray(q, dtype=float)
    if w * w + x * x + y * y + z * z < 1e-8:
        return np.eye(3)
    return Rotation.from_quat([x, y, z, w]).as_matrix()


def xyzquat2mat(xyzquat: np.ndarray) -> np.ndarray:
    """The 4x4 transform of [x, y, z, qw, qx, qy, qz]."""
    mat = np.concatenate([quat2mat(xyzquat[3:]),
                          np.asarray(xyzquat[:3], dtype=float)[:, None]], axis=1)
    return np.concatenate([mat, _BOTTOM], axis=0)


def from_xyzquat(xyzquat: np.ndarray) -> np.ndarray:
    """The 4x4 transform [R | -R t] of [tx, ty, tz, qx, qy, qz, qw], R from
    the quaternion in scipy's (x, y, z, w) order."""
    rot = Rotation.from_quat(xyzquat[3:])
    mat = np.concatenate([rot.as_matrix(),
                          rot.apply(-np.asarray(xyzquat[:3], dtype=float))[:, None]], axis=1)
    return np.concatenate([mat, _BOTTOM], axis=0)
