"""Pairwise distances, correspondence search and the mutual gate
(deepsir_tpu/ops/distance.py).

In a search a CUDA tensor goes to kernel K2, or K3 for both directions
(ops/cuda_match.py), a CPU tensor to their plain PyTorch versions; the
searches carry no gradient. `square_distance` is a differentiable torch
op: the feat loss's descriptor distances, which the JAX package computes
with a plain einsum too. It runs at fp32 grade (TF32 is off,
deepsir_tpu_torch/__init__.py). `min_square_distance`, the metrics'
chamfer term, is plain torch too, as it is plain XLA in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from deepsir_tpu_torch.ops.cuda_match import match_argmin, match_argmin_bidirectional
from deepsir_tpu_torch.ops.gather import gather_points


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 by the |a|^2 + |b|^2 - 2ab expansion:
    (..., N, C) x (..., M, C) -> (..., N, M)."""
    d = -2.0 * torch.einsum("...nc,...mc->...nm", src, dst)
    d = d + torch.sum(src * src, dim=-1)[..., :, None]
    return d + torch.sum(dst * dst, dim=-1)[..., None, :]


@torch.no_grad()
def min_square_distance(src: torch.Tensor, ref: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Each src point's least squared distance to ref, by the norm expansion
    |a|^2 + |b|^2 - 2ab in src tiles of `chunk` rows, as
    deepsir_tpu/ops/distance.py:min_square_distance computes it:
    (..., N, C) x (..., M, C) -> (..., N)."""
    ref_sq = torch.sum(ref * ref, dim=-1)[..., None, :]
    parts = []
    for s in range(0, src.shape[-2], chunk):
        tile = src[..., s:s + chunk, :]
        d = (torch.sum(tile * tile, dim=-1)[..., :, None] + ref_sq
             - 2.0 * (tile @ ref.transpose(-1, -2)))
        parts.append(torch.amin(d, dim=-1))
    return torch.cat(parts, dim=-1)


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
