"""The port's correspondence search (deepsir_tpu_torch.ops.distance /
cuda_match, kernel K2's plain version) against the JAX package, on the CPU.

Both compute |r|^2 - 2 s.r and take the first minimum, but sum the dot
products in different orders, so they may differ only where two distances
agree within float32 rounding: mismatched rows must be within 1e-5 relative
in exact (float64) distance.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepsir_tpu.ops.distance import nearest_neighbour_index as jax_nn_index
from deepsir_tpu.ops.pallas_match import match_argmin_single
from deepsir_tpu_torch.ops.cuda_match import match_argmin, match_argmin_plain
from deepsir_tpu_torch.ops.distance import nearest_neighbour_index


def _check(got, want, src, ref):
    bad = got != want
    d = ((src[:, None, :].astype(np.float64) - ref[None]) ** 2).sum(-1)
    rows = np.nonzero(bad)[0]
    np.testing.assert_allclose(d[rows, got[rows]], d[rows, want[rows]], rtol=1e-5)
    assert bad.mean() <= 1e-3


def _port(src, ref):
    return match_argmin_plain(torch.from_numpy(src)[None], torch.from_numpy(ref)[None])[0].numpy()


@pytest.mark.parametrize("n,m,c", [(512, 2048, 64), (1000, 3000, 64),
                                   (700, 513, 100), (100, 257, 3)])
def test_plain_matches_jax_xla(rng, n, m, c):
    src = rng.normal(size=(n, c)).astype(np.float32)
    ref = rng.normal(size=(m, c)).astype(np.float32)
    want = np.asarray(jax_nn_index(src, ref, method="xla"))
    _check(_port(src, ref), want, src, ref)


@pytest.mark.parametrize("n,m,c", [(512, 2048, 64), (700, 2500, 100), (100, 257, 3)])
def test_plain_matches_pallas_interpret(rng, n, m, c):
    src = rng.normal(size=(n, c)).astype(np.float32)
    ref = rng.normal(size=(m, c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(match_argmin_single(src, ref))
    _check(_port(src, ref), want, src, ref)


def test_planted_ties_go_to_lowest_index(rng):
    base = rng.normal(size=(300, 64)).astype(np.float32)
    ref = np.concatenate([base, base[::-1], base], axis=0)    # every row 3x
    src = np.concatenate([base[:100], rng.normal(size=(100, 64)).astype(np.float32)])
    got = _port(src, ref)
    np.testing.assert_array_equal(got[:100], np.arange(100))
    assert got.max() < 300
    want = np.asarray(jax_nn_index(src, ref, method="xla"))
    np.testing.assert_array_equal(got[:100], want[:100])


def test_batched_and_wrapper(rng):
    src = rng.normal(size=(2, 300, 16)).astype(np.float32)
    ref = rng.normal(size=(2, 500, 16)).astype(np.float32)
    got = nearest_neighbour_index(torch.from_numpy(src), torch.from_numpy(ref)).numpy()
    assert got.dtype == np.int64
    for b in range(2):
        np.testing.assert_array_equal(got[b], _port(src[b], ref[b]))


def test_wrapper_rejects_unsupported():
    with pytest.raises(ValueError):
        match_argmin(torch.zeros(1, 4, 8), torch.zeros(2, 4, 8), low_precision=True)
    with pytest.raises(ValueError):
        match_argmin(torch.zeros(1, 4, 129), torch.zeros(1, 4, 129))
