"""The port's KNN search (deepsir_tpu_torch.ops.knn / cuda_knn, kernel K1's
plain version) against the JAX package, on the CPU.

The port computes squared distances by direct subtraction in coordinate order
and sorts them stably; JAX's exact XLA path uses the |q|^2 + |r|^2 - 2 q.r
expansion. The two may order neighbours differently only where two distances
agree within float32 rounding, so index mismatches are allowed only where the
exact (float64) distances are within 1e-5 relative.
"""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepsir_tpu.ops.knn import knn as jax_knn
from deepsir_tpu.ops.pallas_knn import knn_topk_single
from deepsir_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from deepsir_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_plain
from deepsir_tpu_torch.ops.knn import knn
from deepsir_tpu_torch.ops.pyramid import build_pyramid, slice_neighbours

NEAR_TIE_RTOL = 1e-5


def _f32_direct(q, r):
    """Distances summed in coordinate order in float32, as the port does."""
    acc = None
    for c in range(q.shape[1]):
        diff = q[:, None, c] - r[None, :, c]
        acc = diff * diff if acc is None else acc + diff * diff
    return acc


def _f64(q, r):
    return ((q[:, None, :].astype(np.float64) - r[None, :, :]) ** 2).sum(-1)


def _assert_same_or_near_tie(idx, want, d64):
    bad = idx != want
    got_d = np.take_along_axis(d64, idx, axis=1)[bad]
    want_d = np.take_along_axis(d64, want, axis=1)[bad]
    np.testing.assert_allclose(got_d, want_d, rtol=NEAR_TIE_RTOL, atol=1e-9)


def _port(q, r, k):
    idx, dist = knn_topk_plain(torch.from_numpy(q)[None], torch.from_numpy(r)[None], k)
    return idx[0].numpy(), dist[0].numpy()


@pytest.mark.parametrize("n,m,k", [(300, 1000, 16), (257, 2048, 8), (512, 700, 1),
                                   (100, 40, 32)])
def test_plain_matches_jax_exact(rng, n, m, k):
    q = rng.normal(size=(n, 3)).astype(np.float32) * 10
    r = rng.normal(size=(m, 3)).astype(np.float32) * 10
    idx, dist = _port(q, r, k)
    jidx, _ = jax_knn(q, r, k, recall_target=1.0)
    _assert_same_or_near_tie(idx, np.asarray(jidx), _f64(q, r))
    # distances are the direct-subtraction float32 values, bit for bit
    np.testing.assert_array_equal(dist, np.take_along_axis(_f32_direct(q, r), idx, 1))
    assert np.all(np.diff(dist, axis=1) >= 0)


@pytest.mark.parametrize("n,m,k", [(300, 1000, 16), (512, 5000, 16)])
def test_plain_matches_pallas_interpret(rng, n, m, k):
    """Recall floors and distance bounds of tests/test_pallas_knn.py: the TPU
    kernel quantises keys to 8 mantissa bits (and buckets beyond one tile)."""
    q = rng.normal(size=(n, 3)).astype(np.float32) * 10
    r = rng.normal(size=(m, 3)).astype(np.float32) * 10
    idx, dist = _port(q, r, k)
    with pltpu.force_tpu_interpret_mode():
        pidx, pdist = knn_topk_single(q, r, k)
    pidx, pdist = np.asarray(pidx), np.asarray(pdist)
    recall = np.mean([len(set(idx[i]) & set(pidx[i])) / k for i in range(n)])
    assert recall >= (0.99 if m <= 2048 else 0.95)
    # the exact k-th neighbour is never farther than the kernel's
    d = _f64(q, r)
    assert np.all(dist[:, -1] <= np.take_along_axis(d, pidx, 1).max(1) * (1 + 1e-6))
    if m <= 2048:
        np.testing.assert_allclose(pdist, dist, rtol=5e-3, atol=1e-5)


def test_k1_is_first_argmin(rng):
    q = rng.normal(size=(300, 3)).astype(np.float32) * 10
    r = rng.normal(size=(3000, 3)).astype(np.float32) * 10
    idx, _ = _port(q, r, 1)
    np.testing.assert_array_equal(idx[:, 0], np.argmin(_f32_direct(q, r), axis=1))


def test_k_greater_than_m_pads_with_farthest(rng):
    q = rng.normal(size=(50, 3)).astype(np.float32)
    r = rng.normal(size=(5, 3)).astype(np.float32)
    idx, dist = knn(torch.from_numpy(q)[None], torch.from_numpy(r)[None], 8)
    idx, dist = idx[0].numpy(), dist[0].numpy()
    jidx, jdist = jax_knn(q, r, 8, recall_target=1.0)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(idx[:, 5:], np.repeat(idx[:, 4:5], 3, axis=1))
    np.testing.assert_allclose(dist, np.asarray(jdist), rtol=1e-5, atol=1e-5)


def test_duplicate_points_ties_go_to_lowest_index(rng):
    base = rng.normal(size=(100, 3)).astype(np.float32)
    r = np.concatenate([base, base, base], axis=0)
    idx, dist = _port(base[:50], r, 4)
    for i in range(50):
        np.testing.assert_array_equal(idx[i, :3], [i, i + 100, i + 200])
        assert dist[i, 0] == 0.0
    assert all(len(set(row)) == 4 for row in idx.tolist())


def test_batched_equals_per_cloud(rng):
    q = rng.normal(size=(2, 200, 3)).astype(np.float32)
    r = rng.normal(size=(2, 300, 3)).astype(np.float32)
    idx, dist = knn_topk(torch.from_numpy(q), torch.from_numpy(r), 16)
    for b in range(2):
        i1, d1 = _port(q[b], r[b], 16)
        np.testing.assert_array_equal(idx[b].numpy(), i1)
        np.testing.assert_array_equal(dist[b].numpy(), d1)


@pytest.mark.parametrize("recall_target", [1.0, 0.95])
def test_pyramid_matches_jax(rng, recall_target):
    """The whole index pyramid equals JAX's, at both recall settings the JAX
    package uses on the CPU (0.95 is device_batch's default)."""
    pts = rng.normal(size=(2, 1024, 3)).astype(np.float32)
    pyr = build_pyramid(torch.from_numpy(pts), 8, (4, 4))
    jpyr = jax_build_pyramid(pts, num_knn=8, ratios=(4, 4), recall_target=recall_target)
    for field in ("xyz", "neigh_idx", "pool_idx", "interp_idx"):
        for lvl in range(2):
            np.testing.assert_array_equal(getattr(pyr, field)[lvl].numpy(),
                                          np.asarray(getattr(jpyr, field)[lvl]))
    sliced = slice_neighbours(pyr, 4)
    assert sliced.neigh_idx[0].shape[-1] == 4 and sliced.pool_idx[1].shape[-1] == 4
    assert slice_neighbours(pyr, 0) is pyr


@pytest.mark.parametrize("k,d", [(33, 3), (0, 3), (4, 9)])
def test_wrapper_rejects_unsupported(k, d):
    q = torch.zeros(1, 10, d)
    with pytest.raises(ValueError):
        knn_topk(q, torch.zeros(1, 40, d), k)
