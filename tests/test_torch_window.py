"""The port's curve-rank window geometry, Morton sort, windowed KNN (kernel
K4's plain version) and strided Morton pyramid against the JAX package, on
the CPU.

Tolerances and why:
- window geometry and Morton order: integers, equal.
- windowed KNN against JAX's XLA path (`knn(..., window_halo=1)`): the port
  ranks by direct subtraction, JAX by the |q|^2 + |r|^2 - 2 q.r expansion, so
  indices may differ only where the exact (float64) distances are within
  1e-5 relative; the port's distances are bit-equal to a float32
  direct-subtraction oracle over the same window.
- against the interpreted Pallas kernel, which quantises distances to 8
  mantissa bits: the rule of tests/test_pallas_windowed.py (neighbour sets
  agree on > 99% of entries, distances within rtol 4e-3).
- strided pyramid: indices equal but for near ties as above (at most 0.1%).
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepsir_tpu.ops import window as jax_window
from deepsir_tpu.ops.knn import knn as jax_knn
from deepsir_tpu.ops.morton import morton_code_np as jax_morton_code
from deepsir_tpu.ops.morton import morton_order_np as jax_morton_order
from deepsir_tpu.ops.pallas_knn import knn_topk_windowed_single
from deepsir_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from deepsir_tpu_torch.ops import window
from deepsir_tpu_torch.ops.cuda_knn import (knn_topk_plain, knn_topk_windowed,
                                            knn_topk_windowed_plain)
from deepsir_tpu_torch.ops.knn import knn
from deepsir_tpu_torch.ops.morton import morton_code_np, morton_order_np, sort_clouds
from deepsir_tpu_torch.ops.pyramid import build_pyramid

SIZES = [1, 70, 128, 281, 777, 1024, 1125, 1900, 2500, 3000, 4096, 4500, 8192, 18000]


@pytest.mark.parametrize("halo", [1, 2, 3])
def test_window_geometry_equals_jax(halo):
    n_windowed = 0
    for nq in SIZES:
        for nv in SIZES:
            width, start = window.window_geometry(nq, nv, halo)
            jwidth, jstart = jax_window.window_geometry(nq, nv, halo)
            assert width == jwidth, (nq, nv)
            tiles = window.num_blocks(nq, window.TQ)
            assert [start(i) for i in range(tiles)] == \
                [int(jstart(i)) for i in range(tiles)], (nq, nv)
            assert window.windowed(nq, nv, halo) == jax_window.windowed(nq, nv, halo)
            n_windowed += window.windowed(nq, nv, halo)
            rows, starts = window.start_rows(nq, nv, halo)
            assert rows == width * window.VB and len(starts) == tiles
            assert all(0 <= s and s + rows <= window.num_blocks(nv) * window.VB
                       for s in starts)
    assert n_windowed > 0
    assert (window.TQ, window.VB) == (jax_window.TQ, jax_window.VB)


def test_protocol_pyramid_windows():
    """At 18000 points (ratios 4) halo 1 windows exactly the level-0
    self-search, the level-0 upsample and the level-1 self-search."""
    n, got = 18000, []
    for lvl in range(4):
        got += [window.windowed(n, n, 1), window.windowed(n, n // 4, 1)]
        n //= 4
    assert got == [True, True, True, False, False, False, False, False]


@pytest.mark.parametrize("with_valid", [False, True])
def test_morton_order_equals_jax(rng, with_valid):
    pts = rng.normal(size=(3000, 4)).astype(np.float32) * 20.0
    valid = rng.uniform(size=3000) > 0.2 if with_valid else None
    np.testing.assert_array_equal(morton_code_np(pts, valid), jax_morton_code(pts, valid))
    np.testing.assert_array_equal(morton_order_np(pts, valid), jax_morton_order(pts, valid))
    batch = pts.reshape(2, 1500, 4)
    np.testing.assert_array_equal(
        sort_clouds(batch), np.stack([c[jax_morton_order(c[:, :3])] for c in batch]))


def _sorted(rng, n, d=3, b=1):
    pts = rng.normal(size=(b, n, d)).astype(np.float32) * 10.0
    return np.stack([c[morton_order_np(c[:, :3])] for c in pts])


def _f64(q, r):
    return ((q[:, None, :].astype(np.float64) - r[None, :, :]) ** 2).sum(-1)


def _f32_direct(q, r):
    acc = None
    for c in range(q.shape[1]):
        diff = q[:, None, c] - r[None, :, c]
        acc = diff * diff if acc is None else acc + diff * diff
    return acc


def _window_mask(n, m, halo):
    rows, starts = window.start_rows(n, m, halo)
    mask = np.zeros((n, m), bool)
    for i, s in enumerate(starts):
        mask[i * window.TQ:(i + 1) * window.TQ, s:min(m, s + rows)] = True
    return mask


@pytest.mark.parametrize("n,m,k,d,refs", [(2048, 2048, 8, 3, "self"),
                                          (3000, 3000, 16, 3, "self"),
                                          (8192, 2048, 1, 3, "strided"),
                                          (2500, 1900, 4, 3, "other"),
                                          (3000, 3000, 32, 8, "self")])
def test_windowed_plain_matches_jax_xla(rng, n, m, k, d, refs):
    assert window.windowed(n, m, 1)
    q = _sorted(rng, n, d)[0]
    r = {"self": q, "strided": q[::n // m][:m],
         "other": _sorted(rng, m, d)[0]}[refs]
    idx, dist = knn_topk_windowed_plain(torch.from_numpy(q)[None],
                                        torch.from_numpy(np.ascontiguousarray(r))[None], k, 1)
    idx, dist = idx[0].numpy(), dist[0].numpy()
    jidx, _ = jax_knn(q, r, k, window_halo=1)
    jidx = np.asarray(jidx)
    inside = np.take_along_axis(_window_mask(n, m, 1), idx, 1)
    assert inside.all()
    d64 = _f64(q, r)
    bad = idx != jidx
    np.testing.assert_allclose(np.take_along_axis(d64, idx, 1)[bad],
                               np.take_along_axis(d64, jidx, 1)[bad], rtol=1e-5, atol=1e-9)
    assert bad.mean() <= 1e-3
    # distances are the direct-subtraction float32 values, bit for bit, ascending
    np.testing.assert_array_equal(dist, np.take_along_axis(_f32_direct(q, r), idx, 1))
    assert np.all(np.diff(dist, axis=1) >= 0)
    # ... and the k nearest within the window, ties to the lowest index
    d32 = np.where(_window_mask(n, m, 1), _f32_direct(q, r), np.inf)
    want = np.argsort(d32, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx, want)


def test_windowed_plain_matches_pallas_interpret(rng):
    n, k = 2048, 8
    q = _sorted(rng, n)[0]
    idx, dist = knn_topk_windowed_plain(torch.from_numpy(q)[None], torch.from_numpy(q)[None],
                                        k, 1)
    idx, dist = idx[0].numpy(), dist[0].numpy()
    with pltpu.force_tpu_interpret_mode():
        pidx, pdist = knn_topk_windowed_single(q, q, k, 1)
    pidx, pdist = np.asarray(pidx), np.asarray(pdist)
    agree = np.mean([len(np.intersect1d(a, b)) / k for a, b in zip(idx, pidx)])
    assert agree > 0.99, agree
    np.testing.assert_allclose(dist, pdist, rtol=4e-3, atol=1e-5)
    np.testing.assert_array_equal(idx[:, 0], np.arange(n))


def test_knn_dispatch_and_batch(rng):
    q = torch.from_numpy(_sorted(rng, 3000, b=2))
    sub = q[:, ::4][:, :750].contiguous()
    # windowed where the window is smaller than the refs, else the full search
    got = knn(q, q, 16, window_halo=1)
    want = knn_topk_windowed_plain(q, q, 16, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not window.windowed(3000, 750, 1)
    got = knn(q, sub, 1, window_halo=1)
    want = knn_topk_plain(q, sub, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # batch elements are independent searches
    both, _ = knn_topk_windowed(q, q, 16, 1)
    assert both.dtype == torch.int64
    for b in range(2):
        one, _ = knn_topk_windowed(q[b:b + 1].contiguous(), q[b:b + 1].contiguous(), 16, 1)
        assert torch.equal(one[0], both[b])
    with pytest.raises(ValueError):
        knn_topk_windowed(torch.zeros(1, 3000, 9), torch.zeros(1, 3000, 9), 4, 1)
    with pytest.raises(ValueError):
        knn_topk_windowed(q, q, 33, 1)


def _assert_pyramid_near_ties(got, want, query, cand):
    got = got.numpy().reshape(got.shape[0], got.shape[1], -1)
    want = np.asarray(want).reshape(got.shape)
    bad = got != want
    assert bad.mean() <= 1e-3
    for b, i, j in zip(*np.nonzero(bad)):
        d_g = ((cand[b, got[b, i, j]].astype(np.float64) - query[b, i]) ** 2).sum()
        d_w = ((cand[b, want[b, i, j]].astype(np.float64) - query[b, i]) ** 2).sum()
        np.testing.assert_allclose(d_g, d_w, rtol=1e-5, atol=1e-9)


def test_strided_pyramid_matches_jax(rng):
    pts = _sorted(rng, 8192, b=2)
    ratios = (4, 4, 4)
    pyr = build_pyramid(torch.from_numpy(pts), 16, ratios, sample="strided", window_halo=1)
    jpyr = jax_build_pyramid(pts, num_knn=16, ratios=ratios, sample="strided",
                             window_halo=1)
    xyz = pts
    for lvl, r in enumerate(ratios):
        np.testing.assert_array_equal(pyr.xyz[lvl].numpy(), np.asarray(jpyr.xyz[lvl]))
        nxt = xyz[:, ::r][:, :xyz.shape[1] // r]
        _assert_pyramid_near_ties(pyr.neigh_idx[lvl], jpyr.neigh_idx[lvl], xyz, xyz)
        _assert_pyramid_near_ties(pyr.pool_idx[lvl], jpyr.pool_idx[lvl], nxt, xyz)
        _assert_pyramid_near_ties(pyr.interp_idx[lvl], jpyr.interp_idx[lvl], xyz, nxt)
        xyz = nxt
    with pytest.raises(NotImplementedError, match="sample"):
        build_pyramid(torch.from_numpy(pts), 16, ratios, sample="random")
