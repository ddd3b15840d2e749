"""SO(3) helpers on the host (deepsir_tpu/math/so3.py)."""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def dcm2euler(mats: np.ndarray, seq: str = "zyx", degrees: bool = True) -> np.ndarray:
    """Rotation matrices (B, 3, 3) -> Euler angles (B, 3), through scipy."""
    return Rotation.from_matrix(np.asarray(mats)).as_euler(seq, degrees=degrees)
