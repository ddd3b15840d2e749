"""Correspondence RANSAC with every hypothesis drawn at once, and RANSAC
over feature matches (deepsir_tpu/ops/ransac.py).

All minimal samples are drawn in one call, solved as one batch of Kabsch
problems and scored with one (H, P) inlier count; the best hypothesis (the
first on ties) is refit on all its inliers. The JAX package draws its
samples with its own generator (threefry), which torch cannot reproduce: a
caller that must match it passes JAX's draws as `picks`. The feature
matches come from `ops.distance.nearest_neighbour_index`, which is kernel K2
on a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepsir_tpu_torch.ops import distance
from deepsir_tpu_torch.ops.svd3 import weighted_kabsch


@torch.no_grad()
def ransac_correspondence(src: torch.Tensor, ref: torch.Tensor, corres: torch.Tensor,
                          threshold: float, num_hypotheses: int = 4096,
                          generator: Optional[torch.Generator] = None,
                          picks: Optional[torch.Tensor] = None,
                          valid: Optional[torch.Tensor] = None, min_sample: int = 3
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC over the putative pairs of one cloud pair.

    src (N, 3), ref (M, 3); corres (P, 2) src/ref row pairs, of which
    `valid` (P,) bool marks the real ones (all if None): a padded pair
    weighs nothing in a sample's solve, counts as no inlier, and is left
    out of the polish and of the fraction. The samples are `picks`
    (H, min_sample) rows of corres if given, else H = num_hypotheses drawn
    uniformly from `generator`. Returns (transform (3, 4), inlier fraction
    of the valid pairs).
    """
    p = corres.shape[0]
    if valid is None:
        valid = torch.ones(p, dtype=torch.bool, device=src.device)
    a = src[corres[:, 0]]                                   # (P, 3)
    b = ref[corres[:, 1]]
    if picks is None:
        picks = torch.randint(0, p, (num_hypotheses, min_sample), generator=generator,
                              device=src.device)
    picks = picks.to(device=src.device, dtype=torch.int64)
    transforms, bad = weighted_kabsch(a[picks], b[picks], valid[picks].to(src.dtype))

    moved = torch.einsum("hij,pj->hpi", transforms[:, :, :3], a) + transforms[:, None, :, 3]
    dist = torch.linalg.vector_norm(moved - b[None], dim=-1)          # (H, P)
    inlier = (dist < threshold) & valid[None]
    score = inlier.sum(dim=1) - torch.where(bad, p + 1, 0)
    best = torch.argmax(score)      # the first of the best: torch's argmax, as jnp's

    t, _ = weighted_kabsch(a, b, inlier[best].to(src.dtype))
    return t, inlier[best].sum().to(src.dtype) / valid.sum().clamp_min(1).to(src.dtype)


@torch.no_grad()
def ransac_feature_matching(src: torch.Tensor, ref: torch.Tensor, feat_src: torch.Tensor,
                            feat_ref: torch.Tensor, threshold: float,
                            num_hypotheses: int = 4096,
                            generator: Optional[torch.Generator] = None,
                            picks: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC over feature matches (the reference's
    registration_ransac_based_on_feature_matching): each src point's
    nearest ref descriptor, one way, at fp32 grade (feat_src (N, C),
    feat_ref (M, C); one K2 launch on the card), then
    `ransac_correspondence` over those N pairs. Returns (transform (3, 4),
    inlier fraction)."""
    idx = distance.nearest_neighbour_index(feat_src[None], feat_ref[None])[0]
    corres = torch.stack([torch.arange(src.shape[0], device=idx.device), idx], dim=1)
    return ransac_correspondence(src, ref, corres, threshold, num_hypotheses,
                                 generator=generator, picks=picks)
