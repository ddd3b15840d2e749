"""Curve-rank window geometry of the windowed KNN (deepsir_tpu/ops/window.py).

With clouds sorted along a space-filling curve (ops/morton.py), a point's
spatial neighbours are mostly index neighbours, so a pyramid level's KNN
searches only a window of curve ranks. Query tile i (TQ rows of an nq-row
query array) searches value blocks [start_block(i), start_block(i) + width)
of VB rows each of the nv-row value array, where width = 2*halo + s and s is
the number of value blocks one query tile sweeps after level-ratio scaling.
Python ints only: the kernel K4 (`csrc/knn_windowed.cu`) and its plain
version read the per-tile start table this module computes, so both use one
definition of the window, and it equals the JAX package's.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

TQ = 128      # query rows per tile
VB = 512      # value rows per window block


def num_blocks(n: int, vb: int = VB) -> int:
    return -(-n // vb)


def window_geometry(nq: int, nv: int, halo: int, tq: int = TQ,
                    vb: int = VB) -> Tuple[int, Callable[[int], int]]:
    """(width in blocks, start_block) for nq queries searching nv values.

    start_block(i) is the first value block of query tile i's window,
    clamped to [0, nvb - width]. A window that covers the whole value array
    has width num_blocks(nv) and start 0.
    """
    nvb = num_blocks(nv, vb)
    s = max(1, (tq * nv) // (nq * vb))     # value blocks swept per tile
    width = 2 * halo + s
    if width >= nvb:
        return nvb, lambda i: 0
    hi = nvb - width

    def start_block(i: int) -> int:
        center = ((i * tq + tq // 2) * nv // nq) // vb
        return max(0, min(center - width // 2, hi))

    return width, start_block


def windowed(nq: int, nv: int, halo: int, tq: int = TQ, vb: int = VB) -> bool:
    """True when the window is a strict subset of the value array."""
    width, _ = window_geometry(nq, nv, halo, tq, vb)
    return width < num_blocks(nv, vb)


def start_rows(nq: int, nv: int, halo: int) -> Tuple[int, List[int]]:
    """(window rows, first value row of each query tile's window).

    A tile searches rows [start, min(nv, start + window rows)).
    """
    width, start_block = window_geometry(nq, nv, halo)
    return width * VB, [start_block(i) * VB for i in range(num_blocks(nq, TQ))]
