"""Index gathers for channel-last point arrays (deepsir_tpu/ops/gather.py).

Batch dims are folded into one flat row axis with offset int64 indices and
gathered with one `index_select`, as the reference does with its flat row
gather. Results are bit-identical to the reference (pure data movement).
"""
from __future__ import annotations

import torch


def _flat_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (..., N, C) x idx (..., M) -> (..., M, C)."""
    *batch, n, c = values.shape
    m = idx.shape[-1]
    b = 1
    for d in batch:
        b *= d
    off = torch.arange(b, device=idx.device, dtype=torch.int64) * n
    flat = (idx.reshape(b, m).to(torch.int64) + off[:, None]).reshape(b * m)
    out = values.reshape(b * n, c).index_select(0, flat)
    return out.reshape(*batch, m, c)


def gather_points(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (..., N, C); idx (..., M) -> (..., M, C)."""
    return _flat_rows(values, idx)


def gather_neighbour(values: torch.Tensor, neigh_idx: torch.Tensor) -> torch.Tensor:
    """values (..., N, C); neigh_idx (..., M, K) -> (..., M, K, C)."""
    *batch, m, k = neigh_idx.shape
    out = _flat_rows(values, neigh_idx.reshape(*batch, m * k))
    return out.reshape(*batch, m, k, values.shape[-1])


def max_pool_neighbours(features: torch.Tensor, pool_idx: torch.Tensor) -> torch.Tensor:
    """features (..., N, C); pool_idx (..., M, K) -> (..., M, C)."""
    return gather_neighbour(features, pool_idx).amax(dim=-2)


def nearest_interpolate(features: torch.Tensor, interp_idx: torch.Tensor) -> torch.Tensor:
    """features (..., N, C); interp_idx (..., M) or (..., M, 1) -> (..., M, C)."""
    if interp_idx.shape[-1] == 1 and interp_idx.dim() == features.dim():
        interp_idx = interp_idx[..., 0]
    return gather_points(features, interp_idx)
