"""The two operand forms of the port's correspondence search, on the CPU.

- The bf16 (`low_precision`) form: the plain versions of kernels K2 and K3
  (deepsir_tpu_torch.ops.cuda_match) against the JAX package's Pallas
  kernels with low_precision=True, run interpreted. Both round src and ref
  to bf16 for the products (bf16 products are exact in fp32) and take the
  norms from the fp32 inputs; they sum in different orders, so they may
  differ only on near ties of the bf16 form's own distance
  |s|^2 + |r|^2 - 2 bf16(s).bf16(r): at most 0.1% of rows (or columns),
  each within 1e-5 relative of the other's, in float64. Planted exact ties
  must go to the lowest index both ways exactly.
- The fp32-grade form: a numpy emulation of the kernels' 3xTF32 products
  (csrc/match_core.cuh: big = rna_tf32(x), small = rna_tf32(x - big),
  small.big + big.small + big.big per 8-channel step, fp32 sums) against
  the fp32 plain version, under the fp32 near-tie rule, and why three
  products: one TF32 product errs ~1000x more than fp32 does.
"""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepsir_tpu.ops.pallas_match import match_argmin_bidirectional as pallas_bidir
from deepsir_tpu.ops.pallas_match import match_argmin_single
from deepsir_tpu_torch.ops.cuda_match import (match_argmin, match_argmin_bidirectional,
                                              match_argmin_bidirectional_plain,
                                              match_argmin_plain)
from deepsir_tpu_torch.ops.distance import (nearest_neighbour_bidirectional,
                                            nearest_neighbour_index)


def _bf16(x):
    """x rounded to bf16 (to nearest even), as float64."""
    return torch.from_numpy(x).to(torch.bfloat16).double().numpy()


def _lp_dist(qry, cand):
    """The bf16 form's distances in float64: fp32 norms, bf16 operands."""
    q64, c64 = qry.astype(np.float64), cand.astype(np.float64)
    return ((q64 ** 2).sum(-1)[:, None] + (c64 ** 2).sum(-1)[None]
            - 2.0 * _bf16(qry) @ _bf16(cand).T)


def _near_ties(got, want, d):
    """got/want index the columns of d (float64, one row per query)."""
    got, want = np.asarray(got), np.asarray(want)
    bad = got != want
    rows = np.nonzero(bad)[0]
    np.testing.assert_allclose(d[rows, got[rows]], d[rows, want[rows]], rtol=1e-5)
    assert bad.mean() <= 1e-3


def _t(x):
    return torch.from_numpy(x)[None]


SHAPES = [(512, 2048, 64), (1000, 3000, 64), (700, 5000, 128), (100, 257, 16),
          (1030, 513, 16)]


@pytest.mark.parametrize("n,m,c", SHAPES)
def test_lp_plain_matches_pallas_interpret(rng, n, m, c):
    src = rng.normal(size=(n, c)).astype(np.float32)
    ref = rng.normal(size=(m, c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(match_argmin_single(src, ref, low_precision=True))
    got = match_argmin_plain(_t(src), _t(ref), low_precision=True)[0].numpy()
    _near_ties(got, want, _lp_dist(src, ref))


@pytest.mark.parametrize("n,m,c", [(512, 2048, 64), (700, 2500, 64), (1030, 513, 16)])
def test_lp_bidir_plain_matches_pallas_interpret(rng, n, m, c):
    src = rng.normal(size=(n, c)).astype(np.float32)
    ref = rng.normal(size=(m, c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        widx, wridx = pallas_bidir(src, ref, low_precision=True)
    idx, ridx = match_argmin_bidirectional_plain(_t(src), _t(ref), low_precision=True)
    d = _lp_dist(src, ref)
    _near_ties(idx[0].numpy(), widx, d)
    _near_ties(ridx[0].numpy(), wridx, d.T)


def test_lp_differs_from_fp32_where_bf16_rounding_decides(rng):
    """The bf16 form is not the fp32 search: on unit descriptors it moves
    some rows, each to a row no farther in the bf16 form's own distance."""
    src = rng.normal(size=(512, 64)).astype(np.float32)
    ref = rng.normal(size=(2048, 64)).astype(np.float32)
    src /= np.linalg.norm(src, axis=1, keepdims=True)
    ref /= np.linalg.norm(ref, axis=1, keepdims=True)
    lp = match_argmin_plain(_t(src), _t(ref), low_precision=True)[0].numpy()
    fp = match_argmin_plain(_t(src), _t(ref))[0].numpy()
    assert (lp != fp).any()
    d = _lp_dist(src, ref)
    rows = np.arange(len(lp))
    assert (d[rows, lp] <= d[rows, fp] * (1 + 1e-6) + 1e-6).all()


def test_lp_planted_ties_go_to_lowest_index_both_ways(rng):
    base = rng.normal(size=(300, 64)).astype(np.float32)
    tripled = np.concatenate([base, base[::-1], base], axis=0)  # every row 3x
    head = np.ascontiguousarray(base[:100])
    want = np.arange(100)
    np.testing.assert_array_equal(
        match_argmin_plain(_t(head), _t(tripled), low_precision=True)[0].numpy(), want)
    idx, _ = match_argmin_bidirectional_plain(_t(head), _t(tripled), low_precision=True)
    np.testing.assert_array_equal(idx[0].numpy(), want)
    _, ridx = match_argmin_bidirectional_plain(_t(tripled), _t(head), low_precision=True)
    np.testing.assert_array_equal(ridx[0].numpy(), want)
    with pltpu.force_tpu_interpret_mode():
        np.testing.assert_array_equal(
            np.asarray(match_argmin_single(head, tripled, low_precision=True)), want)
        _, wridx = pallas_bidir(tripled, head, low_precision=True)
    np.testing.assert_array_equal(np.asarray(wridx), want)


def test_lp_cpu_wrappers_take_the_plain_path(rng):
    src = torch.from_numpy(rng.normal(size=(2, 300, 32)).astype(np.float32))
    ref = torch.from_numpy(rng.normal(size=(2, 500, 32)).astype(np.float32))
    counters = (match_argmin, match_argmin_bidirectional)
    before = [(fn.launches, fn.launches_lp) for fn in counters]
    want = match_argmin_plain(src, ref, low_precision=True)
    wboth = match_argmin_bidirectional_plain(src, ref, low_precision=True)
    assert torch.equal(match_argmin(src, ref, low_precision=True), want)
    assert torch.equal(nearest_neighbour_index(src, ref, low_precision=True), want)
    for got in (match_argmin_bidirectional(src, ref, low_precision=True),
                nearest_neighbour_bidirectional(src, ref, low_precision=True)):
        assert torch.equal(got[0], wboth[0]) and torch.equal(got[1], wboth[1])
    assert [(fn.launches, fn.launches_lp) for fn in counters] == before


def _rna_tf32(x):
    """cvt.rna.tf32.f32 by bit arithmetic, as csrc/match_core.cuh does it."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def test_rna_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                                   # TF32 keeps 10 mantissa bits
    x = np.array([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, 1 + ulp, 3.0 * 2 ** -30],
                 np.float32)
    want = np.array([1.0, 1 + ulp, 1.0, 1 + ulp, 3.0 * 2 ** -30], np.float32)
    np.testing.assert_array_equal(_rna_tf32(x), want)
    np.testing.assert_array_equal(_rna_tf32(-x), -want)
    assert (_rna_tf32(np.float32(1.0) + np.arange(8192, dtype=np.float32) * 2 ** -23)
            .view(np.uint32) & 0x1fff == 0).all()


def test_3xtf32_emulation_is_fp32_grade(rng):
    """The kernels' fp32-grade products, emulated: 3xTF32 picks the plain fp32
    version's rows (near-tie rule) and errs no more than an fp32 dot product;
    a single TF32 product errs ~1000x more."""
    def unit(n):
        x = rng.normal(size=(n, 64)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    src, ref = unit(1024), unit(4096)

    def split(x):
        big = _rna_tf32(x)
        return big, _rna_tf32(x - big)
    (sb, ss), (rb, rs) = split(src), split(ref)
    acc3 = np.zeros((1024, 4096), np.float32)
    acc1 = np.zeros_like(acc3)
    for k in range(0, 64, 8):                          # one m16n8k8 step each
        sl = slice(k, k + 8)
        acc3 += ss[:, sl] @ rb[:, sl].T
        acc3 += sb[:, sl] @ rs[:, sl].T
        acc3 += sb[:, sl] @ rb[:, sl].T
        acc1 += sb[:, sl] @ rb[:, sl].T
    dot64 = src.astype(np.float64) @ ref.astype(np.float64).T
    err3 = np.abs(acc3 - dot64).max()
    err1 = np.abs(acc1 - dot64).max()
    err32 = np.abs(src @ ref.T - dot64).max()
    assert err3 <= 2 * err32 and err1 >= 100 * err32

    ref_sq = (ref * ref).sum(-1)
    got = np.argmin(ref_sq[None] - 2.0 * acc3, axis=1)
    want = match_argmin_plain(_t(src), _t(ref))[0].numpy()
    d = ((src.astype(np.float64) ** 2).sum(-1)[:, None]
         + (ref.astype(np.float64) ** 2).sum(-1)[None] - 2.0 * dot64)
    _near_ties(got, want, d)
