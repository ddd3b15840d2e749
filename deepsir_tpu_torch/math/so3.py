"""SO(3) helpers on the host (deepsir_tpu/math/so3.py): Euler angles and
the rotation of points."""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def dcm2euler(mats: np.ndarray, seq: str = "zyx", degrees: bool = True) -> np.ndarray:
    """Rotation matrices (B, 3, 3) -> Euler angles (B, 3), through scipy."""
    return Rotation.from_matrix(np.asarray(mats)).as_euler(seq, degrees=degrees)


def transform(g: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply the rotation g (3, 3) to points (N, 3)."""
    return pts @ g[:3, :3].T
