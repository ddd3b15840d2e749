"""Plain PyTorch operations of the reference: gathers, the exact KNN and the
index pyramid, the descriptor search, SE(3) helpers and the weighted Kabsch
solve with its 3x3 SVD.

A frozen copy of the plain paths of the port's `ops/gather.py`,
`ops/cuda_knn.py::knn_topk_plain`, `ops/pyramid.py`,
`ops/cuda_match.py::match_argmin*_plain`, `math/se3.py` and `ops/svd3.py`,
cut to the options the benchmark's configurations use (shuffled clouds, no
windows, fp32). Nothing here imports the port.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_CHUNK_ELEMS = 1 << 24          # distance-tile budget of the searches
_EPS = 1e-16
_JACOBI_SWEEPS = 8


# ---------------------------------------------------------------- gathers

def gather_points(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (..., N, C); idx (..., M) -> (..., M, C)."""
    *batch, n, c = values.shape
    m = idx.shape[-1]
    b = 1
    for d in batch:
        b *= d
    off = torch.arange(b, device=idx.device, dtype=torch.int64) * n
    flat = (idx.reshape(b, m).to(torch.int64) + off[:, None]).reshape(b * m)
    return values.reshape(b * n, c).index_select(0, flat).reshape(*batch, m, c)


def gather_neighbour(values: torch.Tensor, neigh_idx: torch.Tensor) -> torch.Tensor:
    """values (..., N, C); neigh_idx (..., M, K) -> (..., M, K, C)."""
    *batch, m, k = neigh_idx.shape
    out = gather_points(values, neigh_idx.reshape(*batch, m * k))
    return out.reshape(*batch, m, k, values.shape[-1])


# ---------------------------------------------------------------- KNN and pyramid

def _sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """sum_d (q_d - r_d)^2 in coordinate order, each operation rounded alone."""
    acc = None
    for c in range(q.shape[-1]):
        diff = q[..., c] - r[..., c]
        sq = diff * diff
        acc = sq if acc is None else acc + sq
    return acc


def knn(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, D) x (B, M, D) -> the k nearest ref rows (B, N, k) int64,
    ascending, ties to the lowest index; k > M repeats the farthest."""
    b, n, _ = query.shape
    m = ref.shape[1]
    kk = min(k, m)
    chunk = max(1, _CHUNK_ELEMS // max(1, b * m))
    parts = []
    for s in range(0, n, chunk):
        _, idx = torch.sort(_sq_dist(query[:, s:s + chunk, None], ref[:, None]),
                            dim=-1, stable=True)
        parts.append(idx[..., :kk])
    idx = torch.cat(parts, dim=1)
    if k > m:
        idx = torch.cat([idx, idx[..., -1:].expand(*idx.shape[:-1], k - m)], dim=-1)
    return idx


class Pyramid(NamedTuple):
    xyz: Tuple[torch.Tensor, ...]          # (B, N_l, 3)
    neigh_idx: Tuple[torch.Tensor, ...]    # (B, N_l, K)
    pool_idx: Tuple[torch.Tensor, ...]     # (B, N_{l+1}, K)
    interp_idx: Tuple[torch.Tensor, ...]   # (B, N_l)


def build_pyramid(xyz: torch.Tensor, num_knn: int, ratios) -> Pyramid:
    """The RandLA index pyramid of shuffled clouds (B, N, 3): per level a
    num_knn self-search, the first N_l / r points as the next level, and
    each point's nearest next-level point."""
    xyzs, neighs, pools, interps = [], [], [], []
    pc = xyz.contiguous()
    for r in ratios:
        n_next = pc.shape[-2] // r
        neigh = knn(pc, pc, num_knn)
        sub = pc[:, :n_next].contiguous()
        up = knn(pc, sub, 1)
        xyzs.append(pc)
        neighs.append(neigh)
        pools.append(neigh[:, :n_next])
        interps.append(up[..., 0])
        pc = sub
    return Pyramid(tuple(xyzs), tuple(neighs), tuple(pools), tuple(interps))


def concat_pyramids(a: Pyramid, b: Pyramid) -> Pyramid:
    return Pyramid(*(tuple(torch.cat([x, y], dim=0) for x, y in zip(fa, fb))
                     for fa, fb in zip(a, b)))


# ---------------------------------------------------------------- descriptor search

@torch.no_grad()
def match(src: torch.Tensor, ref: torch.Tensor, bidirectional: bool = False):
    """Nearest ref row of every src row under squared L2, (B, N, C) x (B, M, C)
    -> (B, N) int64; with `bidirectional` also the nearest src row of every
    ref row (B, M), ties to the lowest index both ways."""
    b, n, _ = src.shape
    m = ref.shape[1]
    ref_sq = torch.sum(ref * ref, dim=-1)
    src_sq = torch.sum(src * src, dim=-1)
    ref_t = ref.transpose(1, 2)
    chunk = max(1, _CHUNK_ELEMS // max(1, b * m))
    parts = []
    col_d = torch.full((b, m), float("inf"), dtype=src.dtype, device=src.device)
    col_i = torch.zeros((b, m), dtype=torch.int64, device=src.device)
    for s in range(0, n, chunk):
        d = ref_sq[:, None, :] - 2.0 * torch.bmm(src[:, s:s + chunk], ref_t)
        parts.append(torch.argmin(d, dim=-1))
        if bidirectional:
            dc = d + src_sq[:, s:s + chunk, None]
            arg = torch.argmin(dc, dim=1)
            best = torch.gather(dc, 1, arg[:, None, :])[:, 0]
            take = best < col_d
            col_d = torch.where(take, best, col_d)
            col_i = torch.where(take, arg + s, col_i)
    idx = torch.cat(parts, dim=1)
    return (idx, col_i) if bidirectional else idx


# ---------------------------------------------------------------- SE(3)

def se3_identity(b: int, device) -> torch.Tensor:
    return torch.eye(3, 4, device=device).expand(b, 3, 4).clone()


def se3_concatenate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ra, ta = a[..., :3, :3], a[..., :3, 3:4]
    rb, tb = b[..., :3, :3], b[..., :3, 3:4]
    return torch.cat([ra @ rb, ra @ tb + ta], dim=-1)


def se3_transform(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ g[..., :3, :3].transpose(-1, -2) + g[..., :3, 3][..., None, :]


# ---------------------------------------------------------------- SVD and Kabsch

def _eye_like(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=a.dtype, device=a.device).expand(a.shape).clone()


def _jacobi_eigh3(a: torch.Tensor):
    """Symmetric (..., 3, 3) -> (w (..., 3), v (..., 3, 3)) by cyclic Jacobi."""
    v = _eye_like(a)
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq, app, aqq = a[..., p, q], a[..., p, p], a[..., q, q]
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
    pick = torch.argmin(torch.abs(u), dim=-1)
    basis = torch.nn.functional.one_hot(pick, 3).to(u.dtype)
    c = torch.linalg.cross(u, basis, dim=-1)
    return c / (_norm(c) + _EPS)


def _svd3x3(mats: torch.Tensor):
    w, v = _jacobi_eigh3(mats.transpose(-1, -2) @ mats)
    order = torch.argsort(w, dim=-1, stable=True).flip(-1)
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
    sgn = torch.sign(torch.sum(av[..., :, 2] * u2, dim=-1))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    v = torch.cat([v[..., :, :2], v[..., :, 2:] * sgn[..., None, None]], dim=-1)
    return u, s, v.transpose(-1, -2)


class _SVD3x3(torch.autograd.Function):
    """Jacobi SVD forward; the square-SVD adjoint with Tikhonov-clamped gaps
    as its backward."""

    @staticmethod
    def forward(ctx, mats):
        u, s, vt = _svd3x3(mats)
        ctx.save_for_backward(u, s, vt)
        return u, s, vt

    @staticmethod
    def backward(ctx, du, ds, dvt):
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


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def weighted_kabsch(src: torch.Tensor, tgt: torch.Tensor, weights: torch.Tensor):
    """T with T*src ~= tgt under `weights`: (transform (B, 3, 4), invalid (B,));
    the identity where the solve is not finite."""
    w = weights[..., None]
    w_norm = w / (torch.sum(torch.abs(w), dim=-2, keepdim=True) + _EPS)
    centroid_src = torch.sum(src * w_norm, dim=-2)
    centroid_tgt = torch.sum(tgt * w_norm, dim=-2)
    src_c = src - centroid_src[..., None, :]
    tgt_c = tgt - centroid_tgt[..., None, :]
    cov = src_c.transpose(-1, -2) @ (tgt_c * w_norm)
    scale = torch.sqrt(torch.sum(cov * cov, dim=(-2, -1), keepdim=True))
    cov_n = cov / (scale + _EPS)
    bad_cov = ~torch.all(torch.isfinite(cov_n).flatten(-2), dim=-1)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device).expand(cov.shape)
    cov_n = torch.where(bad_cov[..., None, None], eye, cov_n)
    u, _, vt = _SVD3x3.apply(cov_n)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    with torch.no_grad():
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
