"""SE(3) rigid transforms on torch tensors (deepsir_tpu/math/se3.py).

Transforms are (..., 3, 4) matrices [R | t] and broadcast over leading batch
dims; points are (..., N, 3).
"""
from __future__ import annotations

import math

import torch


def identity(batch_shape=(), device=None, dtype=torch.float32) -> torch.Tensor:
    """Identity transform of shape (*batch_shape, 3, 4)."""
    eye = torch.eye(3, 4, device=device, dtype=dtype)
    return eye.expand(*tuple(batch_shape), 3, 4).clone()


def inverse(g: torch.Tensor) -> torch.Tensor:
    """Inverse of an SE3 transform (..., 3/4, 4) -> (..., 3, 4)."""
    inv_rot = g[..., :3, :3].transpose(-1, -2)
    inv_trans = -(inv_rot @ g[..., :3, 3:4])
    return torch.cat([inv_rot, inv_trans], dim=-1)


def concatenate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two SE3 transforms: returns a @ b as a (..., 3, 4) matrix."""
    ra, ta = a[..., :3, :3], a[..., :3, 3:4]
    rb, tb = b[..., :3, :3], b[..., :3, 3:4]
    return torch.cat([ra @ rb, ra @ tb + ta], dim=-1)


def transform(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply SE3 transform g (..., 3/4, 4) to points (..., N, 3)."""
    rot = g[..., :3, :3]
    trans = g[..., :3, 3]
    return pts @ rot.transpose(-1, -2) + trans[..., None, :]


def pose_error(g_gt: torch.Tensor, g_pred: torch.Tensor, eps: float = 1e-16):
    """Residual rotation (degrees) and translation magnitude of inv(gt) @ pred
    (deepsir_tpu/math/se3.py:92). Metrics only: the arccos argument is
    clipped to [-1 + eps, 1 - eps], which in fp32 is [-1, 1] at the default
    eps, so its gradient is not finite at zero error."""
    residual = concatenate(inverse(g_gt), g_pred)
    rot_trace = residual[..., 0, 0] + residual[..., 1, 1] + residual[..., 2, 2]
    cos = torch.clamp(0.5 * (rot_trace - 1.0), -1.0 + eps, 1.0 - eps)
    err_r_deg = torch.arccos(cos) * (180.0 / math.pi)
    err_t = torch.linalg.vector_norm(residual[..., :, 3], dim=-1)
    return err_r_deg, err_t


def rotation_error_rad(r1: torch.Tensor, r2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Geodesic rotation error arccos((tr(R1^T R2) - 1) / 2) in radians,
    (..., 3, 3) x (..., 3, 3) -> (...) (deepsir_tpu/math/se3.py:66). The
    clip at 1 - 1e-6, which fp32 resolves, keeps the gradient finite at zero
    error; the pose loss differentiates it."""
    trace = torch.sum(r1 * r2, dim=(-2, -1))
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0 + eps, 1.0 - eps)
    return torch.arccos(cos)


def translation_error(t1: torch.Tensor, t2: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2 translation error (..., 3) -> (...) as sqrt(|d|^2 + eps), whose
    gradient is finite at zero (deepsir_tpu/math/se3.py:81)."""
    d = t1 - t2
    return torch.sqrt(torch.sum(d * d, dim=-1) + eps)
