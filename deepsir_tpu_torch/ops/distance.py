"""Correspondence search (deepsir_tpu/ops/distance.py::nearest_neighbour_index).

A CUDA tensor goes to kernel K2 (ops/cuda_match.py), a CPU tensor to its
plain PyTorch version. The search carries no gradient.
"""
from __future__ import annotations

import torch

from deepsir_tpu_torch.ops.cuda_match import match_argmin


@torch.no_grad()
def nearest_neighbour_index(feat_src: torch.Tensor, feat_ref: torch.Tensor,
                            low_precision: bool = False) -> torch.Tensor:
    """Nearest ref row under squared L2 for every src row.

    feat_src (B, N, C), feat_ref (B, M, C) -> (B, N) int64.
    """
    return match_argmin(feat_src.contiguous(), feat_ref.contiguous(),
                        low_precision=low_precision)
