"""Correspondence RANSAC with every hypothesis drawn at once
(deepsir_tpu/ops/ransac.py::ransac_correspondence).

All minimal samples are drawn in one call, solved as one batch of 3-point
Kabsch problems and scored with one (H, P) inlier count; the best
hypothesis (the first on ties) is refit on all its inliers. The JAX package
draws its samples with its own generator (threefry), which torch cannot
reproduce: a caller that must match it passes JAX's draws as `picks`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepsir_tpu_torch.ops.svd3 import weighted_kabsch


@torch.no_grad()
def ransac_correspondence(src: torch.Tensor, ref: torch.Tensor, corres: torch.Tensor,
                          threshold: float, num_hypotheses: int = 4096,
                          generator: Optional[torch.Generator] = None,
                          picks: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC over the putative pairs of one cloud pair.

    src (N, 3), ref (M, 3); corres (P, 2) src/ref row pairs, all real (the
    JAX function's `valid` mask, which no caller passes, is left out). The
    3-point samples are `picks` (H, 3) rows of corres if given, else H =
    num_hypotheses drawn uniformly from `generator`. Returns (transform
    (3, 4), inlier fraction).
    """
    p = corres.shape[0]
    a = src[corres[:, 0]]                                   # (P, 3)
    b = ref[corres[:, 1]]
    if picks is None:
        picks = torch.randint(0, p, (num_hypotheses, 3), generator=generator,
                              device=src.device)
    picks = picks.to(device=src.device, dtype=torch.int64)
    sa, sb = a[picks], b[picks]
    transforms, bad = weighted_kabsch(sa, sb, torch.ones_like(sa[..., 0]))

    moved = torch.einsum("hij,pj->hpi", transforms[:, :, :3], a) + transforms[:, None, :, 3]
    dist = torch.linalg.vector_norm(moved - b[None], dim=-1)          # (H, P)
    inlier = dist < threshold
    score = inlier.sum(dim=1) - torch.where(bad, p + 1, 0)
    best = torch.argmax(score)      # the first of the best: torch's argmax, as jnp's

    t, _ = weighted_kabsch(a, b, inlier[best].to(src.dtype))
    return t, inlier[best].sum().to(src.dtype) / p
