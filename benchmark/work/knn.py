"""Work of the pyramid's exact KNN searches (kernel K1, `csrc/knn_topk.cu`,
or whatever computes them later), from their shapes alone.

One search of B batches of N queries against M refs in D dimensions, k
neighbours: D subtractions, D products and D - 1 additions per pair
distance (8 at D = 3) at the fp32 CUDA-core peak; every query and ref read
once, every index (8 bytes) and distance (4 bytes) written once.
"""
from __future__ import annotations

from typing import List, Tuple

from benchmark import peaks


def work(b: int, n: int, m: int, d: int, k: int) -> Tuple[float, float]:
    """(operations, bytes) of one search."""
    return (3.0 * d - 1) * b * n * m, 4.0 * b * (n + m) * d + 12.0 * b * n * k


def bound_s(b: int, n: int, m: int, d: int, k: int) -> float:
    return peaks.bound_s(*work(b, n, m, d, k), peaks.FP32_FLOPS)


def pyramid_searches(points: int, num_knn: int, ratios, clouds: int) -> List[Tuple]:
    """(b, n, m, d, k) of every search that builds `clouds` shuffled-order
    pyramids: per level a k-NN self-search and a 1-NN search into the next
    level (k larger than the level is cut to it)."""
    out, n = [], points
    for r in ratios:
        nxt = n // r
        out.append((clouds, n, n, 3, min(num_knn, n)))
        out.append((clouds, n, nxt, 3, 1))
        n = nxt
    return out
