"""Pairwise distances, correspondence search and the mutual gate
(deepsir_tpu/ops/distance.py).

In a search a CUDA tensor goes to kernel K2, or K3 for both directions
(ops/cuda_match.py), a CPU tensor to their plain PyTorch versions; the
searches carry no gradient. `square_distance` and `match_features` are
differentiable torch ops: the feat loss's descriptor distances, which the
JAX package computes with a plain einsum too. They run at fp32 grade (TF32
is off, deepsir_tpu_torch/__init__.py). `pairwise_dist_chunked` reduces the
(N, M) distance matrix tile by tile, with the gradient of its reduce;
`min_square_distance`, the metrics' chamfer term, is its row minimum
without a gradient, and `nearest_square_distance` the same minimum with
the chamfer losses' gradient. All are plain torch, as they are plain XLA in
the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from deepsir_tpu_torch.ops.cuda_match import match_argmin, match_argmin_bidirectional
from deepsir_tpu_torch.ops.gather import gather_points


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 by the |a|^2 + |b|^2 - 2ab expansion:
    (..., N, C) x (..., M, C) -> (..., N, M)."""
    d = -2.0 * torch.einsum("...nc,...mc->...nm", src, dst)
    d = d + torch.sum(src * src, dim=-1)[..., :, None]
    return d + torch.sum(dst * dst, dim=-1)[..., None, :]


def match_features(feat_src: torch.Tensor, feat_ref: torch.Tensor,
                   metric: str = "l2") -> torch.Tensor:
    """Pairwise feature distance matrix (..., J, C) x (..., K, C) -> (..., J, K):
    squared L2 ("l2"), its square root with 1e-12 under it ("euclidean"), or
    the angle between the unit-normalised rows ("angle")."""
    if metric == "l2":
        return square_distance(feat_src, feat_ref)
    if metric == "euclidean":
        return torch.sqrt(square_distance(feat_src, feat_ref) + 1e-12)
    if metric == "angle":
        src = feat_src / (torch.linalg.vector_norm(feat_src, dim=-1, keepdim=True) + 1e-12)
        ref = feat_ref / (torch.linalg.vector_norm(feat_ref, dim=-1, keepdim=True) + 1e-12)
        return torch.arccos(torch.clamp(torch.einsum("...nc,...mc->...nm", src, ref), -1.0, 1.0))
    raise NotImplementedError(metric)


def _distance_tiles(src: torch.Tensor, ref: torch.Tensor, chunk: int):
    """The (..., chunk, M) squared-distance tiles of src's rows against ref,
    by the norm expansion |a|^2 + |b|^2 - 2ab as deepsir_tpu/ops/distance.py
    computes them; the last tile holds the rows left."""
    ref_sq = torch.sum(ref * ref, dim=-1)[..., None, :]
    for s in range(0, src.shape[-2], chunk):
        tile = src[..., s:s + chunk, :]
        yield (torch.sum(tile * tile, dim=-1)[..., :, None] + ref_sq
               - 2.0 * (tile @ ref.transpose(-1, -2)))


def pairwise_dist_chunked(src: torch.Tensor, ref: torch.Tensor,
                          reduce_fn: Callable[[torch.Tensor], torch.Tensor],
                          chunk: int = 2048) -> torch.Tensor:
    """A reduction over the (N, M) squared-distance matrix, never built whole.

    src (..., N, C), ref (..., M, C). `reduce_fn` maps each (..., chunk, M)
    tile of `chunk` src rows to (..., chunk, ...); the tiles' results are
    joined along the row axis. The gradient flows through `reduce_fn`.
    """
    return torch.cat([reduce_fn(d) for d in _distance_tiles(src, ref, chunk)],
                     dim=src.dim() - 2)


def _row_min(d: torch.Tensor) -> torch.Tensor:
    return torch.amin(d, dim=-1)


@torch.no_grad()
def min_square_distance(src: torch.Tensor, ref: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Each src point's least squared distance to ref, in src tiles of
    `chunk` rows (`pairwise_dist_chunked`), as
    deepsir_tpu/ops/distance.py:min_square_distance computes it:
    (..., N, C) x (..., M, C) -> (..., N). No gradient: the metrics' term;
    the chamfer losses take `nearest_square_distance`."""
    return pairwise_dist_chunked(src, ref, _row_min, chunk)


def nearest_square_distance(src: torch.Tensor, ref: torch.Tensor,
                            chunk: int = 2048) -> torch.Tensor:
    """`min_square_distance` with a gradient, for the chamfer losses:
    (..., N, C) x (..., M, C) -> (..., N).

    The value is the tiled minimum's, bit for bit. The gradient is the norm
    expansion's at each row's nearest ref row (the first on exact ties,
    where JAX's tiled minimum shares it among them), from the pairs alone,
    so no (N, M) tile is kept for the backward.
    """
    with torch.no_grad():
        mins, near = zip(*(torch.min(d, dim=-1) for d in _distance_tiles(src, ref, chunk)))
    partner = gather_points(ref, torch.cat(near, dim=-1))
    live = (torch.sum(src * src, dim=-1) + torch.sum(partner * partner, dim=-1)
            - 2.0 * torch.sum(src * partner, dim=-1))
    return torch.cat(mins, dim=-1) + (live - live.detach())


@torch.no_grad()
def nearest_neighbour_index(feat_src: torch.Tensor, feat_ref: torch.Tensor,
                            low_precision: bool = False) -> torch.Tensor:
    """Nearest ref row under squared L2 for every src row.

    feat_src (B, N, C), feat_ref (B, M, C) -> (B, N) int64.
    """
    return match_argmin(feat_src.contiguous(), feat_ref.contiguous(),
                        low_precision=low_precision)


@torch.no_grad()
def nearest_neighbour_bidirectional(feat_src: torch.Tensor, feat_ref: torch.Tensor,
                                    low_precision: bool = False):
    """Both directions of the search in one pass: feat_src (B, N, C),
    feat_ref (B, M, C) -> (idx (B, N), ridx (B, M)) int64, where idx[i] is
    the nearest ref row of src row i and ridx[j] the nearest src row of ref
    row j. `low_precision` takes bf16 operands for the products."""
    return match_argmin_bidirectional(feat_src.contiguous(), feat_ref.contiguous(),
                                      low_precision=low_precision)


def mutual_gate(idx: torch.Tensor, reverse_idx: torch.Tensor, min_keep: int = 3,
                src_xyz: Optional[torch.Tensor] = None,
                tol: float = 0.0) -> torch.Tensor:
    """Mutual nearest-neighbour mask over a correspondence set.

    idx (..., N): src row i matched to ref row idx[i]; reverse_idx (..., M):
    ref row j matched to src row reverse_idx[j]. Returns a float32 (..., N)
    mask: 1 where the match is reciprocal (reverse_idx[idx[i]] == i), else 0.
    With tol > 0 (needs src_xyz (..., N, 3)) a match is kept when the reverse
    match lands within tol of the source point. Where fewer than `min_keep`
    matches of a cloud survive, its gate opens fully (all ones), so the solve
    never sees an empty correspondence set.
    """
    n = idx.shape[-1]
    back = gather_points(reverse_idx[..., None], idx)[..., 0]   # (..., N)
    if tol > 0.0:
        if src_xyz is None:
            raise ValueError("the relaxed mutual gate (tol > 0) needs src_xyz")
        d2 = torch.sum((gather_points(src_xyz, back) - src_xyz) ** 2, dim=-1)
        mutual = d2 <= tol * tol
    else:
        mutual = back == torch.arange(n, dtype=back.dtype, device=back.device)
    keep = torch.sum(mutual, dim=-1, keepdim=True) >= min_keep
    return torch.where(keep, mutual.to(torch.float32),
                       torch.ones((), dtype=torch.float32, device=idx.device))
