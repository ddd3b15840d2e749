"""Exact k-nearest-neighbour search (deepsir_tpu/ops/knn.py::knn).

Neighbours come back ascending by squared distance, ties to the lowest ref
index. A CUDA tensor goes to kernel K1 (ops/cuda_knn.py), or to K4 when the
search is restricted to curve-rank windows; a CPU tensor to their plain
PyTorch versions. k > M pads by repeating the farthest neighbour, as the
reference does for tiny deepest pyramid levels (knn.py:36-41), so every index
stays valid for later gathers.
"""
from __future__ import annotations

import torch

from deepsir_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_windowed
from deepsir_tpu_torch.ops.window import windowed


def knn(query: torch.Tensor, ref: torch.Tensor, k: int, window_halo: int = 0):
    """query (B, N, D), ref (B, M, D) -> (idx (B, N, k) int64, sq_dist (B, N, k)).

    window_halo > 0 restricts each query tile to its ops/window.py window of
    curve ranks (valid only for curve-sorted clouds) wherever that window is
    smaller than the ref array; elsewhere the search is over all of it.
    """
    m = ref.shape[-2]
    if window_halo > 0 and windowed(query.shape[-2], m, window_halo):
        return knn_topk_windowed(query, ref, k, window_halo)
    if k > m:
        idx, dist = knn_topk(query, ref, m)
        pad = k - m
        idx = torch.cat([idx, idx[..., -1:].expand(*idx.shape[:-1], pad)], dim=-1)
        dist = torch.cat([dist, dist[..., -1:].expand(*dist.shape[:-1], pad)], dim=-1)
        return idx, dist
    return knn_topk(query, ref, k)
