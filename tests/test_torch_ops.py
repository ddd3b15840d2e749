"""The port's gathers, SE(3) helpers and pose solve against the JAX package,
on the CPU.

Gathers move data only, so they must be bit-equal. The SVD and the Kabsch
solve run the same algorithm in float32 with a different summation order:
values agree to 1e-5.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import numpy as np
import pytest
import torch

from deepsir_tpu.math import se3 as jse3
from deepsir_tpu.ops import gather as jgather
from deepsir_tpu.ops.svd3 import svd3x3 as jax_svd3x3
from deepsir_tpu.ops.svd3 import weighted_kabsch as jax_kabsch
from deepsir_tpu_torch.math import se3
from deepsir_tpu_torch.ops import gather
from deepsir_tpu_torch.ops.svd3 import svd3x3, weighted_kabsch

T = torch.from_numpy


def _random_transforms(rng, b):
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1)
    t = rng.normal(size=(b, 3, 1))
    return np.concatenate([rot, t], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["gather_points", "gather_neighbour",
                                  "max_pool_neighbours", "nearest_interpolate"])
def test_gathers_bit_equal(rng, name):
    values = rng.normal(size=(2, 64, 5)).astype(np.float32)
    if name == "gather_points":
        idx = rng.integers(0, 64, size=(2, 40))
    elif name == "nearest_interpolate":
        idx = rng.integers(0, 64, size=(2, 100, 1))
    else:
        idx = rng.integers(0, 64, size=(2, 16, 8))
    got = getattr(gather, name)(T(values), T(idx)).numpy()
    want = np.asarray(getattr(jgather, name)(values, idx.astype(np.int32)))
    np.testing.assert_array_equal(got, want)


def test_se3_matches_jax(rng):
    a, b = _random_transforms(rng, 3), _random_transforms(rng, 3)
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(se3.transform(T(a), T(pts)).numpy(),
                               np.asarray(jse3.transform(a, pts)), atol=1e-5)
    np.testing.assert_allclose(se3.concatenate(T(a), T(b)).numpy(),
                               np.asarray(jse3.concatenate(a, b)), atol=1e-5)
    np.testing.assert_allclose(se3.inverse(T(a)).numpy(),
                               np.asarray(jse3.inverse(a)), atol=1e-5)
    ident = se3.concatenate(se3.inverse(T(a)), T(a)).numpy()
    np.testing.assert_allclose(ident, np.tile(np.eye(3, 4), (3, 1, 1)), atol=1e-5)


def test_svd3x3_matches_jax(rng):
    """Full-rank matrices: u, s, vt agree with JAX. Rank-deficient ones (rows
    0 and 1): their zero singular values are square roots of round-off-level
    eigenvalues and their null-space vectors are any orthonormal completion,
    so only s^2, the reconstruction and orthonormality are held."""
    mats = rng.normal(size=(64, 3, 3)).astype(np.float32)
    mats[0] = 0.0                                          # all-zero: fallbacks
    mats[1] = np.outer([1, 2, 3], [0.5, -1, 2])            # rank one
    u, s, vt = svd3x3(T(mats))
    ju, js, jvt = (np.asarray(x) for x in jax_svd3x3(mats))
    np.testing.assert_allclose(s[2:].numpy(), js[2:], atol=1e-5)
    np.testing.assert_allclose(u[2:].numpy(), ju[2:], atol=1e-4)
    np.testing.assert_allclose(vt[2:].numpy(), jvt[2:], atol=1e-4)
    np.testing.assert_allclose(s[:2].numpy() ** 2, js[:2] ** 2, atol=1e-5)
    recon = u @ torch.diag_embed(s) @ vt
    np.testing.assert_allclose(recon.numpy(), mats, atol=1e-4)
    eye = np.broadcast_to(np.eye(3), (64, 3, 3))
    np.testing.assert_allclose((u @ u.transpose(1, 2)).numpy(), eye, atol=1e-5)


def test_weighted_kabsch_matches_jax(rng):
    g = _random_transforms(rng, 4)
    src = rng.normal(size=(4, 200, 3)).astype(np.float32)
    tgt = (src @ g[:, :, :3].transpose(0, 2, 1) + g[:, None, :, 3]
           + 0.01 * rng.normal(size=src.shape)).astype(np.float32)
    w = rng.uniform(size=(4, 200)).astype(np.float32)
    w[1] = 0.0                                             # zero weights
    src[2, 5] = np.nan                                     # NaN covariance
    tr, bad = weighted_kabsch(T(src), T(tgt), T(w))
    jtr, jbad = jax_kabsch(src, tgt, w)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
    assert bad.tolist() == [False, False, True, False]
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), atol=1e-5)
    np.testing.assert_array_equal(tr[2].numpy(), np.eye(3, 4))
    np.testing.assert_allclose(tr[[0, 3]].numpy(), g[[0, 3]], atol=1e-2)
