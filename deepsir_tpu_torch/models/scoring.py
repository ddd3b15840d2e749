"""Keypoint scoring (deepsir_tpu/models/scoring.py).

saliency x isolation x channel-max ratio x gated semantic weight, channel
last, parameter-free.
"""
from __future__ import annotations

from typing import Tuple

import torch

from deepsir_tpu_torch.ops.gather import gather_neighbour, gather_points

_EPS = 1e-16

# per-class score weights, indexed by SemanticKITTI learning-map class - 1
LABEL_WEIGHTS = (3, 1, 1, 3, 2,
                 0, 0, 0, 6, 5,
                 6, 4, 7, 7, 6,
                 8, 4, 9, 9)

AGGREGATION_BALL_R = 2.0       # isolation radius
PROB_GATE = 0.2                # semantic confidence gate

_LABEL_WEIGHTS = {}                     # LABEL_WEIGHTS by (dtype, device)


def _label_weights(dtype, device) -> torch.Tensor:
    """LABEL_WEIGHTS on `device`, copied there once: a copy from the host in
    every forward would wait for the device, and cannot be captured in a
    CUDA graph."""
    weights = _LABEL_WEIGHTS.get((dtype, device))
    if weights is None:
        weights = _LABEL_WEIGHTS[dtype, device] = torch.tensor(LABEL_WEIGHTS, dtype=dtype,
                                                               device=device)
    return weights


def score_points(feat: torch.Tensor, xyz: torch.Tensor, logits: torch.Tensor,
                 neigh_idx: torch.Tensor, k_neighbours: int = 16) -> torch.Tensor:
    """feat (B, N, C), xyz (B, N, 3), logits (B, N, classes), neigh_idx (B, N, K)
    -> scores (B, N) in [0, inf)."""
    neigh_idx = neigh_idx[..., :k_neighbours]
    max_per_sample = torch.amax(feat, dim=(-2, -1), keepdim=True)
    feat_n = feat / (max_per_sample + _EPS)

    both = gather_neighbour(torch.cat([feat_n, xyz], dim=-1), neigh_idx)
    local_max = torch.nn.functional.softplus(feat_n - torch.mean(both[..., :-3], dim=-2))

    rel = both[..., -3:] - xyz[..., :, None, :]
    mean_dist = torch.mean(torch.linalg.vector_norm(rel, dim=-1), dim=-1)
    isolation = (mean_dist < AGGREGATION_BALL_R).to(feat.dtype)[..., None]

    depth_max = torch.amax(feat_n, dim=-1, keepdim=True)
    channel_ratio = feat_n / (depth_max + _EPS)

    # as in the reference, `prob` is the max RAW logit normalised by the
    # per-sample max, not a softmax probability
    prob, label = torch.max(logits, dim=-1)
    weights = _label_weights(feat.dtype, feat.device)
    label_score = weights[label]
    label_score = label_score / (torch.amax(label_score, dim=-1, keepdim=True) + _EPS)
    prob_n = prob / (torch.amax(prob, dim=-1, keepdim=True) + _EPS)
    label_score = label_score * (prob_n > PROB_GATE)

    score = local_max * isolation * channel_ratio * label_score[..., None]
    return torch.amax(score, dim=-1)


def top_k_select(score: torch.Tensor, k: int, *arrays: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """Keep the k highest-scoring points and gather companion arrays.

    Equal scores keep the lower index first, as `jax.lax.top_k` does."""
    top_scores, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[..., :k], idx[..., :k]
    return (top_scores,) + tuple(gather_points(a, idx) for a in arrays)
