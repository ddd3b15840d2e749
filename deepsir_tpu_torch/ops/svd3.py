"""Batched 3x3 SVD and weighted Kabsch pose solve (deepsir_tpu/ops/svd3.py).

The SVD is the reference's closed-form route: 8 sweeps of cyclic Jacobi on
A^T A give V and s^2, U's columns are A v_i / s_i with an orthonormal
completion for (near-)zero singular values. Its gradient is the reference's
custom VJP, the square-SVD adjoint with Tikhonov-clamped gaps
(`_SVD3x3.backward`), so autograd never unrolls the Jacobi sweeps. The
Kabsch solve keeps the reference's weight normalisation, covariance scaling
and det flip, and is differentiable in the weights and the target points; a
non-finite result gives the identity and sets `invalid`.
"""
from __future__ import annotations

import torch

_EPS = 1e-16
_JACOBI_SWEEPS = 8


def _eye_like(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=a.dtype, device=a.device).expand(a.shape).clone()


def _jacobi_eigh3(a: torch.Tensor):
    """Symmetric (..., 3, 3) -> (w (..., 3), v (..., 3, 3)), a ~= v diag(w) v^T."""
    v = _eye_like(a)
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = a[..., p, q]
            app = a[..., p, p]
            aqq = a[..., q, q]
            tiny = torch.abs(apq) < 1e-30
            theta = (aqq - app) / (2.0 * torch.where(tiny, torch.ones_like(apq), apq))
            t = torch.sign(theta) / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
            t = torch.where(tiny, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            j = _eye_like(a)
            j[..., p, p] = c
            j[..., q, q] = c
            j[..., p, q] = s
            j[..., q, p] = -s
            a = j.transpose(-1, -2) @ a @ j
            v = v @ j
    return torch.stack([a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]], dim=-1), v


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def _orthogonal_to(u: torch.Tensor) -> torch.Tensor:
    """Any unit vector orthogonal to u (..., 3), branchless."""
    pick = torch.argmin(torch.abs(u), dim=-1)
    basis = torch.nn.functional.one_hot(pick, 3).to(u.dtype)
    c = torch.linalg.cross(u, basis, dim=-1)
    return c / (_norm(c) + _EPS)


def _svd3x3_impl(mats: torch.Tensor):
    ata = mats.transpose(-1, -2) @ mats
    w, v = _jacobi_eigh3(ata)
    order = torch.argsort(w, dim=-1, stable=True).flip(-1)            # desc
    w = torch.gather(w, -1, order)
    v = torch.gather(v, -1, order[..., None, :].expand(v.shape))
    s = torch.sqrt(torch.clamp(w, min=0.0))

    av = mats @ v
    s0 = s[..., 0:1]
    big = s0 > 1e-12
    u0 = av[..., :, 0] / torch.where(big, s0, torch.ones_like(s0))
    e0 = torch.zeros_like(u0)
    e0[..., 0] = 1.0
    u0 = torch.where(big, u0, e0)
    u0 = u0 / (_norm(u0) + _EPS)

    u1 = av[..., :, 1]
    u1 = u1 - torch.sum(u1 * u0, dim=-1, keepdim=True) * u0
    n1 = _norm(u1)
    u1 = torch.where(n1 > 1e-12, u1 / (n1 + _EPS), _orthogonal_to(u0))

    u2 = torch.linalg.cross(u0, u1, dim=-1)
    u = torch.stack([u0, u1, u2], dim=-1)
    # A v2 may point opposite u2: fold the sign into v's last column
    sgn = torch.sign(torch.sum(av[..., :, 2] * u2, dim=-1))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    v = torch.cat([v[..., :, :2], v[..., :, 2:] * sgn[..., None, None]], dim=-1)
    return u, s, v.transpose(-1, -2)


class _SVD3x3(torch.autograd.Function):
    """The Jacobi SVD forward, with the square-SVD adjoint as its backward
    (deepsir_tpu/ops/svd3.py:122-149)."""

    @staticmethod
    def forward(ctx, mats):
        u, s, vt = _svd3x3_impl(mats)
        ctx.save_for_backward(u, s, vt)
        return u, s, vt

    @staticmethod
    def backward(ctx, du, ds, dvt):
        """dA = U [diag(ds) + J_u S + S J_v] V^T with J_u = F o (U^T dU - dU^T U),
        J_v = F o (V^T dV - dV^T V), F_ij = d / (d^2 + 1e-10) for
        d = s_j^2 - s_i^2 off the diagonal and 0 on it."""
        u, s, vt = ctx.saved_tensors
        v, dv = vt.transpose(-1, -2), dvt.transpose(-1, -2)
        s2 = s * s
        diff = s2[..., None, :] - s2[..., :, None]
        eye = torch.eye(3, dtype=s.dtype, device=s.device)
        f = diff / (diff * diff + 1e-10) * (1.0 - eye)
        sd = s[..., None, :] * eye
        dsd = ds[..., None, :] * eye
        utdu = u.transpose(-1, -2) @ du
        vtdv = v.transpose(-1, -2) @ dv
        j_u = f * (utdu - utdu.transpose(-1, -2))
        j_v = f * (vtdv - vtdv.transpose(-1, -2))
        return u @ (dsd + j_u @ sd + sd @ j_v) @ vt


def svd3x3(mats: torch.Tensor):
    """SVD of batched 3x3 matrices (..., 3, 3) -> (u, s, vt), s descending."""
    return _SVD3x3.apply(mats)


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def weighted_kabsch(src: torch.Tensor, tgt: torch.Tensor, weights: torch.Tensor):
    """Weighted rigid alignment T with T*src ~= tgt.

    src, tgt (..., M, 3); weights (..., M), need not be normalised.
    Returns (transform (..., 3, 4), invalid (...) bool); the transform is the
    identity where the solve produced non-finite values.
    """
    w = weights[..., None]
    w_norm = w / (torch.sum(torch.abs(w), dim=-2, keepdim=True) + _EPS)
    centroid_src = torch.sum(src * w_norm, dim=-2)
    centroid_tgt = torch.sum(tgt * w_norm, dim=-2)
    src_c = src - centroid_src[..., None, :]
    tgt_c = tgt - centroid_tgt[..., None, :]
    cov = src_c.transpose(-1, -2) @ (tgt_c * w_norm)                  # (..., 3, 3)

    scale = torch.sqrt(torch.sum(cov * cov, dim=(-2, -1), keepdim=True))
    cov_n = cov / (scale + _EPS)
    bad_cov = ~torch.all(torch.isfinite(cov_n).flatten(-2), dim=-1)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device).expand(cov.shape)
    cov_n = torch.where(bad_cov[..., None, None], eye, cov_n)

    u, _, vt = svd3x3(cov_n)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    with torch.no_grad():                     # only the sign is used, as a select
        det = _det3(v @ ut)
    flip = torch.ones_like(v[..., 0, :])
    flip[..., 2] = torch.where(det > 0, 1.0, -1.0)
    rot = (v * flip[..., None, :]) @ ut

    trans = centroid_tgt - (rot @ centroid_src[..., None])[..., 0]
    transform = torch.cat([rot, trans[..., None]], dim=-1)
    invalid = bad_cov | ~torch.all(torch.isfinite(transform).flatten(-2), dim=-1)
    ident = torch.eye(3, 4, dtype=transform.dtype,
                      device=transform.device).expand(transform.shape)
    return torch.where(invalid[..., None, None], ident, transform), invalid


def weighted_kabsch_soft(src: torch.Tensor, tgt: torch.Tensor, weights: torch.Tensor):
    """Weighted Kabsch over a soft assignment (RPM-style).

    src (..., M, 3), tgt (..., N, 3), weights (..., M, N): each src point's
    virtual target is its weighted mean of tgt, and its row sum of weights
    is its weight in `weighted_kabsch`.
    """
    w_sum = torch.sum(weights, dim=-1, keepdim=True)                  # (..., M, 1)
    virtual_tgt = (weights @ tgt) / (w_sum + _EPS)
    return weighted_kabsch(src, virtual_tgt, w_sum[..., 0])
