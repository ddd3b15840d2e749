"""SE(3) helpers on numpy arrays, for the host side of the eval harness
(the functions of deepsir_tpu/math/se3_np.py that it reads).

Transforms are ([B,] 3/4, 4) matrices [R | t]; points are ([B,] N, 3).
"""
from __future__ import annotations

import numpy as np

_BOTTOM = np.array([[0.0, 0.0, 0.0, 1.0]])


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
