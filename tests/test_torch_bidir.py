"""The port's two-way correspondence search (kernel K3's plain version,
deepsir_tpu_torch.ops.cuda_match / distance) and its mutual gate against the
JAX package, on the CPU.

Both sides compute |r|^2 - 2 s.r (rows) and that plus |s|^2 (columns) and take
the first minimum, but sum the dot products in different orders, so they may
differ only where two distances agree within float32 rounding: mismatched
rows and columns must be within 1e-5 relative in exact (float64) distance,
and at most 0.1% of them may differ. Planted exact ties must go to the lowest
index in both directions exactly. The mutual gate is integer and comparison
logic on the same inputs, so it must equal JAX's exactly.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepsir_tpu.ops.distance import mutual_gate as jax_mutual_gate
from deepsir_tpu.ops.distance import nearest_neighbour_bidirectional as jax_bidir
from deepsir_tpu.ops.pallas_match import match_argmin_bidirectional as pallas_bidir
from deepsir_tpu_torch.ops.cuda_match import (match_argmin_bidirectional,
                                              match_argmin_bidirectional_plain)
from deepsir_tpu_torch.ops.distance import mutual_gate, nearest_neighbour_bidirectional


def _near_ties(got, want, qry, cand):
    """got/want index `cand` rows for every `qry` row."""
    bad = got != want
    d = ((qry[:, None, :].astype(np.float64) - cand[None]) ** 2).sum(-1)
    rows = np.nonzero(bad)[0]
    np.testing.assert_allclose(d[rows, got[rows]], d[rows, want[rows]], rtol=1e-5)
    assert bad.mean() <= 1e-3


def _check(got, want, src, ref):
    (idx, ridx), (widx, wridx) = got, want
    _near_ties(idx, np.asarray(widx), src, ref)
    _near_ties(ridx, np.asarray(wridx), ref, src)


def _port(src, ref):
    idx, ridx = match_argmin_bidirectional_plain(torch.from_numpy(src)[None],
                                                 torch.from_numpy(ref)[None])
    return idx[0].numpy(), ridx[0].numpy()


@pytest.mark.parametrize("n,m,c", [(512, 2048, 64), (700, 2500, 64), (1030, 513, 16),
                                   (100, 257, 3), (1, 300, 8), (300, 1, 8)])
def test_plain_matches_jax_xla(rng, n, m, c):
    src = rng.normal(size=(n, c)).astype(np.float32)
    ref = rng.normal(size=(m, c)).astype(np.float32)
    _check(_port(src, ref), jax_bidir(src, ref, method="xla"), src, ref)


@pytest.mark.parametrize("n,m,c", [(512, 2048, 64), (700, 2500, 64), (1030, 513, 16)])
def test_plain_matches_pallas_interpret(rng, n, m, c):
    src = rng.normal(size=(n, c)).astype(np.float32)
    ref = rng.normal(size=(m, c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_bidir(src, ref)
    _check(_port(src, ref), want, src, ref)


def test_batched_wrapper_matches_jax(rng):
    src = rng.normal(size=(2, 300, 32)).astype(np.float32)
    ref = rng.normal(size=(2, 500, 32)).astype(np.float32)
    idx, ridx = nearest_neighbour_bidirectional(torch.from_numpy(src), torch.from_numpy(ref))
    assert idx.dtype == ridx.dtype == torch.int64
    assert idx.shape == (2, 300) and ridx.shape == (2, 500)
    widx, wridx = jax_bidir(src, ref, method="xla")
    for b in range(2):
        _check((idx[b].numpy(), ridx[b].numpy()),
               (np.asarray(widx[b]), np.asarray(wridx[b])), src[b], ref[b])


def test_far_clouds_padding_never_wins(rng):
    """Clouds offset far from the origin: a zero (padding-like) row would be
    nearer to everything than any real row, so this catches edges that
    compete (pallas_match.py:169-172 puts +inf there)."""
    src = rng.normal(size=(70, 32)).astype(np.float32) + 100.0
    ref = rng.normal(size=(10, 32)).astype(np.float32) + 100.0
    idx, ridx = _port(src, ref)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_bidir(src, ref)
    assert idx.max() < 10 and ridx.max() < 70
    _check((idx, ridx), want, src, ref)


def test_planted_ties_go_to_lowest_index_both_ways(rng):
    base = rng.normal(size=(300, 64)).astype(np.float32)
    tripled = np.concatenate([base, base[::-1], base], axis=0)  # every row 3x
    head = np.ascontiguousarray(base[:100])
    idx, _ = _port(head, tripled)
    np.testing.assert_array_equal(idx, np.arange(100))
    _, ridx = _port(tripled, head)
    np.testing.assert_array_equal(ridx, np.arange(100))
    widx, _ = jax_bidir(head, tripled, method="xla")
    _, wridx = jax_bidir(tripled, head, method="xla")
    np.testing.assert_array_equal(np.asarray(widx), idx)
    np.testing.assert_array_equal(np.asarray(wridx), ridx)


def _gate_inputs(rng, n=200, m=150):
    """A batch of two clouds: the first with 50 planted reciprocal matches,
    the second with two (below min_keep=3, so its gate opens fully)."""
    idx = rng.integers(0, m, size=(2, n)).astype(np.int32)
    ridx = rng.integers(0, n, size=(2, m)).astype(np.int32)
    for b, planted in ((0, 50), (1, 2)):
        rows = rng.choice(n, size=planted, replace=False)
        cols = rng.choice(m, size=planted, replace=False)
        idx[b, rows] = cols
        ridx[b, cols] = rows
        if b == 1:
            # break any reciprocity by chance beyond the planted two
            back = np.take_along_axis(ridx[1], idx[1], 0)
            for i in np.nonzero(back == np.arange(n))[0]:
                if i not in rows:
                    ridx[1, idx[1, i]] = (i + 1) % n
    xyz = rng.normal(size=(2, n, 3)).astype(np.float32)
    return idx, ridx, xyz


@pytest.mark.parametrize("tol", [0.0, 0.6])
def test_mutual_gate_equals_jax(rng, tol):
    idx, ridx, xyz = _gate_inputs(rng)
    got = mutual_gate(torch.from_numpy(idx).long(), torch.from_numpy(ridx).long(),
                      src_xyz=torch.from_numpy(xyz), tol=tol).numpy()
    want = np.asarray(jax_mutual_gate(idx, ridx, src_xyz=xyz, tol=tol))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got[0].mean() < 1.0                # the gate closes some matches


def test_mutual_gate_min_keep_fallback(rng):
    idx, ridx, xyz = _gate_inputs(rng)
    got = mutual_gate(torch.from_numpy(idx).long(), torch.from_numpy(ridx).long()).numpy()
    want = np.asarray(jax_mutual_gate(idx, ridx))
    np.testing.assert_array_equal(got, want)
    back = np.take_along_axis(ridx[1], idx[1], 0)
    assert (back == np.arange(idx.shape[1])).sum() == 2
    np.testing.assert_array_equal(got[1], np.ones(idx.shape[1], np.float32))
    back = np.take_along_axis(ridx[0], idx[0], 0)
    assert got[0].sum() == (back == np.arange(idx.shape[1])).sum() >= 50
    with pytest.raises(ValueError, match="src_xyz"):
        mutual_gate(torch.from_numpy(idx).long(), torch.from_numpy(ridx).long(), tol=0.5)


def test_wrapper_rejects_unsupported():
    with pytest.raises(ValueError):
        match_argmin_bidirectional(torch.zeros(1, 4, 129), torch.zeros(1, 4, 129),
                                   low_precision=True)
    with pytest.raises(ValueError):
        match_argmin_bidirectional(torch.zeros(1, 4, 129), torch.zeros(1, 4, 129))
    with pytest.raises(ValueError):
        match_argmin_bidirectional(torch.zeros(1, 4, 8), torch.zeros(2, 4, 8))
