"""Work of the registration loop's descriptor searches (kernels K2,
`csrc/match_argmin.cu`, and K3, `csrc/match_bidir.cu`, or whatever computes
them later), from their shapes alone.

One search of B batches of N source rows against M reference rows of C
channels: the product 2 N M C, bounded at fp32 grade as three TF32
products at the TF32 peak (the fastest rate of the card that keeps fp32
grade); one pass gives both directions, so the bidirectional search has the
same product. Bytes: both operands and their squared norms read once, the
row (and column) indices written once as 8 bytes each.
"""
from __future__ import annotations

from typing import Tuple

from benchmark import peaks


def work(b: int, n: int, m: int, c: int, bidirectional: bool) -> Tuple[float, float]:
    """(operations of the product, bytes) of one search."""
    flops = 2.0 * b * n * m * c
    nbytes = 4.0 * b * (n + m) * (c + 1) + 8.0 * b * (n + (m if bidirectional else 0))
    return flops, nbytes


def bound_s(b: int, n: int, m: int, c: int, bidirectional: bool) -> float:
    flops, nbytes = work(b, n, m, c, bidirectional)
    return peaks.bound_s(flops, nbytes, peaks.FP32_GRADE_FLOPS)
