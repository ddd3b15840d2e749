"""The selection order of the port's KNN core (deepsir_tpu_torch/csrc/
knn_select.cuh, kernels K1 and K4), modelled in numpy on the CPU and held
equal to the plain versions `knn_topk_plain` and `knn_topk_windowed_plain`.

The model replays what one warp does for one query: refs in tiles of kTile,
taken from the tile across from the query's block and wrapping around, each
tile in 32-ref chunks shared out among the `split` warps of a query
group (chunk c to warp c % split), one ref per lane; the threshold test
`dist <= k-th distance of the warp queue`; a ballot; more than kBitonicMin
candidates merged by the bitonic network (sort descending across lanes,
lane-wise minimum with the queue, bitonic merge), fewer inserted one at a
time where they beat an entry; k = 1 as a running minimum per lane and a butterfly argmin; then the
split warps' queues merged, each reversed into the same minimum-and-merge
step. The constants kTile, kWarps, kQ, kBitonicMin and kWindowTile are read
from knn_select.cuh itself.

The distances fed to the model are the plain version's float32 values, which
the kernel reproduces bit for bit (round-to-nearest intrinsics, no FMA), so
the model tests the order of selection alone: indices must be equal and
distances bit-equal. The clouds plant exact ties at the k-th boundary (a
lower index seen by a higher lane, a lower index in a later split) and a
lattice whose points tie everywhere.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepsir_tpu_torch.ops.cuda_knn import knn_topk_plain, knn_topk_windowed_plain
from deepsir_tpu_torch.ops.morton import sort_clouds
from deepsir_tpu_torch.ops.window import TQ, start_rows, windowed

HEADER = Path(__file__).resolve().parents[1] / "deepsir_tpu_torch" / "csrc" / "knn_select.cuh"
INT_MAX = np.int64(2 ** 31 - 1)
LANE = np.arange(32)


def _constants():
    """The `constexpr int` constants of knn_select.cuh, evaluated in order."""
    consts = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", HEADER.read_text()):
        consts[name] = int(eval(expr, {"__builtins__": {}}, dict(consts)))
    return consts


C = _constants()
SPLITS = [s for s in (1, 2, 4, 8) if s <= C["kWarps"]]


def _less(ad, ai, bd, bi):
    return (ad < bd) | ((ad == bd) & (ai < bi))


def _exchange(d, i, j, up):
    od, oi = d[LANE ^ j], i[LANE ^ j]
    keep_min = ((LANE & j) == 0) == up
    take = np.where(keep_min, _less(od, oi, d, i), _less(d, i, od, oi))
    return np.where(take, od, d), np.where(take, oi, i)


def _sort_descending(d, i):
    size = 2
    while size <= 32:
        j = size // 2
        while j:
            d, i = _exchange(d, i, j, (LANE & size) != 0)
            j //= 2
        size *= 2
    return d, i


def _merge_into(wd, wi, vd, vi):
    """Ascending queue and descending vector -> the 32 smallest, ascending."""
    take = _less(vd, vi, wd, wi)
    d, i = np.where(take, vd, wd), np.where(take, vi, wi)
    j = 16
    while j:
        d, i = _exchange(d, i, j, True)
        j //= 2
    return d, i


def _tile_starts(lo, hi, row, n, split):
    """The tiles of [lo, hi) in the kernel's order: from the one across from
    the block of query `row` (ref row (block middle) * m / n), wrapping."""
    per_block = C["kQ"] * C["kWarps"] // split
    across = (row // per_block * per_block + per_block // 2) * n[1] // n[0]
    starts = list(range(lo, hi, C["kTile"]))
    t0 = (min(max(across, lo), hi - 1) - lo) // C["kTile"]
    return starts[t0:] + starts[:t0]


def _warp_queue(dist_row, lo, hi, k, split, part, row, n):
    """One warp's queue for query `row` of n = (queries, refs): the refs
    [lo, hi) of `dist_row`."""
    wd, wi = np.full(32, np.inf, np.float32), np.full(32, INT_MAX)
    for j0 in _tile_starts(lo, hi, row, n, split):
        chunks = -(-min(C["kTile"], hi - j0) // 32)
        for ch in range(part, chunks, split):
            j = j0 + ch * 32 + LANE
            acc = np.where(j < hi, dist_row[np.minimum(j, hi - 1)], np.float32(np.nan))
            if k == 1:
                take = _less(acc, j, wd, wi)
                wd, wi = np.where(take, acc, wd), np.where(take, j, wi)
                continue
            with np.errstate(invalid="ignore"):
                mask = acc <= wd[k - 1]
            if mask.sum() > C["kBitonicMin"]:
                vd, vi = _sort_descending(np.where(mask, acc, np.float32(np.inf)),
                                         np.where(mask, j, INT_MAX))
                wd, wi = _merge_into(wd, wi, vd, vi)
                continue
            for src in np.flatnonzero(mask):
                cd, ci = acc[src], j[src]
                beat = _less(cd, ci, wd, wi)
                if beat.any():
                    pos = int(np.argmax(beat))
                    wd = np.concatenate([wd[:pos], [cd], wd[pos:31]]).astype(np.float32)
                    wi = np.concatenate([wi[:pos], [ci], wi[pos:31]])
    if k == 1:
        o = 16
        while o:
            od, oi = wd[LANE ^ o], wi[LANE ^ o]
            take = _less(od, oi, wd, wi)
            wd, wi = np.where(take, od, wd), np.where(take, oi, wi)
            o //= 2
        wd = np.where(LANE == 0, wd, np.float32(np.inf))
        wi = np.where(LANE == 0, wi, INT_MAX)
    return wd, wi


def _model(dist_row, lo, hi, k, split, row, n):
    """Query `row`'s k neighbours as the kernel selects them at `split`."""
    wd, wi = _warp_queue(dist_row, lo, hi, k, split, 0, row, n)
    for part in range(1, split):
        vd, vi = _warp_queue(dist_row, lo, hi, k, split, part, row, n)
        wd, wi = _merge_into(wd, wi, vd[::-1], vi[::-1])
    return wi[:k], wd[:k]


def _f32_direct(q, r):
    acc = None
    for c in range(q.shape[1]):
        diff = q[:, None, c] - r[None, :, c]
        acc = diff * diff if acc is None else acc + diff * diff
    return acc


def _planted(rng, k):
    """A query at the origin with k - 1 strictly nearer refs and four exact
    ties at the k-th distance. The lowest tied index, 37 (chunk 1, lane 5),
    lies at a higher lane than the tied copy 66 (chunk 2, lane 2) and, at
    split 2, in the later split warp (chunk 1 goes to warp 1, chunk 2 to
    warp 0); the copies 290 and 511 lie in the next tiles."""
    m = 600
    r = (rng.uniform(20, 30, size=(m, 3)) * rng.choice([-1, 1], (m, 3))).astype(np.float32)
    near = rng.permutation(np.setdiff1d(np.arange(m), [37, 66, 290, 511]))[:k - 1]
    r[near] = rng.uniform(-1, 1, size=(k - 1, 3)).astype(np.float32)
    r[near] *= (np.arange(1, k) / k / np.linalg.norm(r[near], axis=1))[:, None]
    r[[66, 290, 511, 37]] = np.float32([0.0, 2.0, 0.0])
    q = np.concatenate([np.zeros((1, 3), np.float32),
                        rng.normal(size=(7, 3)).astype(np.float32)])
    return q, r


def _lattice(rng, copies=3):
    """Integer points of a 5x5x5 grid, each `copies` times in shuffled order:
    every query ties exactly with many refs at every distance."""
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(-1, 3)
    r = rng.permutation(np.tile(g, (copies, 1))).astype(np.float32)
    return r[:48].copy(), r


def _cloud(name, rng, k):
    if name == "random":
        return (rng.normal(size=(40, 3)).astype(np.float32) * 10,
                rng.normal(size=(700, 3)).astype(np.float32) * 10)
    if name == "random D=8":
        return (rng.normal(size=(24, 8)).astype(np.float32),
                rng.normal(size=(500, 8)).astype(np.float32))
    if name == "lattice":
        return _lattice(rng)
    return _planted(rng, k)


@pytest.mark.parametrize("name,k", [("random", 16), ("random D=8", 32), ("lattice", 1),
                                    ("lattice", 16), ("lattice", 32), ("planted", 1),
                                    ("planted", 16), ("planted", 32)])
def test_selection_order_matches_plain(rng, name, k):
    q, r = _cloud(name, rng, k)
    pidx, pdist = knn_topk_plain(torch.from_numpy(q)[None], torch.from_numpy(r)[None], k)
    pidx, pdist = pidx[0].numpy(), pdist[0].numpy()
    d = _f32_direct(q, r)
    if name == "planted":
        assert pidx[0, k - 1] == 37 and np.sum(d[0] == pdist[0, k - 1]) == 4
    for split in SPLITS:
        for i in range(len(q)):
            idx, dist = _model(d[i], 0, len(r), k, split, i, (len(q), len(r)))
            np.testing.assert_array_equal(idx, pidx[i], err_msg=f"split {split}, query {i}")
            np.testing.assert_array_equal(dist, pdist[i], err_msg=f"split {split}, query {i}")


@pytest.mark.parametrize("name,k", [("random", 16), ("lattice", 16), ("lattice", 1)])
def test_windowed_selection_order_matches_plain(rng, name, k):
    """K4's ranges: each query searches its window tile's rows of ops/window.py
    (every block lies in one tile: queries per block divide kWindowTile)."""
    n = 2048
    if name == "random":
        pts = rng.normal(size=(1, n, 3)).astype(np.float32) * 10
    else:
        g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
        pts = np.tile(g, (4, 1))[None].astype(np.float32)
    pts = sort_clouds(pts)
    assert windowed(n, n, 1)
    rows, starts = start_rows(n, n, 1)
    t = torch.from_numpy(pts)
    pidx, pdist = knn_topk_windowed_plain(t, t, k, 1)
    d = _f32_direct(pts[0], pts[0])
    for split in SPLITS:
        assert TQ % (C["kQ"] * C["kWarps"] // split) == 0
        for i in range(0, n, 61):
            lo = starts[i // C["kWindowTile"]]
            idx, dist = _model(d[i], lo, min(n, lo + rows), k, split, i, (n, n))
            np.testing.assert_array_equal(idx, pidx[0, i].numpy(), err_msg=f"split {split}, row {i}")
            np.testing.assert_array_equal(dist, pdist[0, i].numpy())


def test_header_constants_fit_the_model():
    """The model's reading of the header: a tile is one ref per thread, split
    warps share out its 32-ref chunks, and K4's window tile is the one of
    ops/window.py."""
    assert C["kTile"] == 32 * C["kWarps"] == C["kThreads"]
    assert C["kWindowTile"] == TQ
    assert 0 <= C["kBitonicMin"] < 32 and C["kQ"] >= 1
