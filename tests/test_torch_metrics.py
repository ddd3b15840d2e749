"""The port's registration metrics (utils/metrics.py), its host SE(3) and
SO(3) helpers (math/se3_np.py, math/so3.py) and the chamfer term's
`ops/distance.min_square_distance`, against the JAX package on the same
numpy inputs, on the CPU.

Tolerances and why:
- dcm2euler, se3_np, rte_rre, the Euler errors (r_mse, r_mae, t_mse,
  t_mae), summarize_metrics and the printed report: equal. Both packages
  run the same numpy and scipy code on the same float32 arrays.
- min_square_distance: 1e-5 of the largest |a|^2 + |b|^2 of a row. Both
  expand |a|^2 + |b|^2 - 2ab in float32; the products sum in another order.
- err_t: 1e-6 relative; err_r_deg: 1e-3 deg on poses at least 2 deg off
  (the float32 arccos is well conditioned there); chamfer_dist: 1e-5
  relative; succ: equal.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from deepsir_tpu.math import se3_np as jax_se3_np
from deepsir_tpu.math import so3 as jax_so3
from deepsir_tpu.ops.distance import min_square_distance as jax_min_square_distance
from deepsir_tpu.utils import metrics as jax_metrics
from deepsir_tpu_torch.math import se3_np, so3
from deepsir_tpu_torch.ops.distance import min_square_distance
from deepsir_tpu_torch.utils import metrics


def random_poses(rng, b, max_deg=40.0, min_deg=0.0, trans=2.0):
    """(B, 3, 4) float32 poses rotated by min_deg..max_deg about random axes."""
    axes = rng.normal(size=(b, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ang = np.deg2rad(rng.uniform(min_deg, max_deg, size=(b, 1)))
    out = np.zeros((b, 3, 4), np.float32)
    out[:, :, :3] = Rotation.from_rotvec(axes * ang).as_matrix()
    out[:, :, 3] = rng.uniform(-trans, trans, size=(b, 3))
    return out


def compose(a, b):
    """a @ b of (B, 3, 4) poses, as float32."""
    return jax_se3_np.concatenate(a, b).astype(np.float32)


@pytest.mark.parametrize("seq", ["xyz", "zyx"])
def test_dcm2euler(rng, seq):
    mats = random_poses(rng, 16, max_deg=170.0)[:, :, :3]
    np.testing.assert_array_equal(so3.dcm2euler(mats, seq=seq),
                                  jax_so3.dcm2euler(mats, seq=seq))


@pytest.mark.parametrize("rows", [3, 4])
@pytest.mark.parametrize("fn", ["transform", "inverse", "concatenate", "to_4x4"])
def test_se3_np(rng, fn, rows):
    g = jax_se3_np.to_4x4(random_poses(rng, 5))[:, :rows]
    h = jax_se3_np.to_4x4(random_poses(rng, 5))[:, :rows]
    args = {"transform": (g, rng.normal(size=(5, 7, 3)).astype(np.float32)),
            "inverse": (g,), "concatenate": (g, h), "to_4x4": (g,)}[fn]
    got, want = getattr(se3_np, fn)(*args), getattr(jax_se3_np, fn)(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m,chunk", [(1024, 2048, 2048), (1500, 700, 512), (33, 65, 16)])
def test_min_square_distance(rng, n, m, chunk):
    a = (rng.normal(size=(2, n, 3)) * 5).astype(np.float32)
    b = (rng.normal(size=(2, m, 3)) * 5).astype(np.float32)
    got = min_square_distance(torch.from_numpy(a), torch.from_numpy(b), chunk=chunk).numpy()
    want = np.asarray(jax_min_square_distance(jnp.asarray(a), jnp.asarray(b), chunk=chunk))
    scale = (a ** 2).sum(-1) + (b ** 2).sum(-1).max(-1, keepdims=True)
    assert got.shape == want.shape == (2, n)
    assert np.abs(got - want).max() <= 1e-5 * scale.max()
    exact = ((a[:, :, None].astype(np.float64) - b[:, None]) ** 2).sum(-1).min(-1)
    assert np.abs(got - exact).max() <= 1e-5 * scale.max()


def test_rte_rre(rng):
    gt = random_poses(rng, 6)
    pred = compose(random_poses(rng, 6, max_deg=8.0, trans=0.8), gt)
    pred[0] = gt[0]                                           # exact
    pred[1, :, :3] = -pred[1, :, :3]                          # far off
    for p, g in zip(pred, gt):
        for thresholds in ((0.6, 5.0), (0.3, 15.0)):
            np.testing.assert_array_equal(metrics.rte_rre(p, g, *thresholds),
                                          jax_metrics.rte_rre(p, g, *thresholds))
    np.testing.assert_array_equal(metrics.rte_rre(None, gt[0], 0.6, 5.0),
                                  jax_metrics.rte_rre(None, gt[0], 0.6, 5.0))


def padded_pairs(rng, b=4, n=1200):
    """Clouds of 7n/12..n raw points tiled to n rows, as the data layer pads
    them, with their validity masks and the raw clouds."""
    raw = rng.integers(n * 7 // 12, n + 1, size=b)
    src, ref = (np.zeros((b, n, 3), np.float32) for _ in range(2))
    raws = []
    for i, k in enumerate(raw):
        s = (rng.normal(size=(k, 3)) * 4).astype(np.float32)
        r = (rng.normal(size=(k, 3)) * 4).astype(np.float32)
        src[i], ref[i] = np.resize(s, (n, 3)), np.resize(r, (n, 3))
        raws.append((s, r))
    mask = (np.arange(n)[None] < raw[:, None]).astype(np.float32)
    return src, ref, mask, raws


@pytest.mark.parametrize("masked", [False, True])
def test_compute_metrics(rng, masked):
    src, ref, mask, raws = padded_pairs(rng)
    gt = random_poses(rng, len(src))
    pred = compose(random_poses(rng, len(src), max_deg=6.0, min_deg=2.0, trans=0.5), gt)
    kw = dict(mask_src=mask, mask_ref=mask) if masked else {}
    got = metrics.compute_metrics(gt, pred, src, ref, 0.6, 5.0, max_points=1024,
                                  device="cpu", **kw)
    want = jax_metrics.compute_metrics(gt, pred, src, ref, 0.6, 5.0, max_points=1024, **kw)
    assert list(got) == list(want)
    for key in ("r_mse", "r_mae", "t_mse", "t_mae", "succ"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["err_t"], want["err_t"], rtol=1e-6)
    np.testing.assert_allclose(got["err_r_deg"], want["err_r_deg"], atol=1e-3)
    np.testing.assert_allclose(got["chamfer_dist"], want["chamfer_dist"], rtol=1e-5)
    if masked:
        # duplicates never change a minimum: the masked means are the
        # natural-size statistics of each raw cloud
        for i, (s, r) in enumerate(raws):
            k = min(len(s), 1024)
            natural = metrics.compute_metrics(gt[i:i + 1], pred[i:i + 1], s[None, :k],
                                              r[None, :k], 0.6, 5.0, max_points=1024,
                                              device="cpu")
            np.testing.assert_allclose(got["chamfer_dist"][i], natural["chamfer_dist"][0],
                                       rtol=1e-5)


def test_summarize_and_print_metrics(rng, caplog):
    src, ref, mask, _ = padded_pairs(rng, b=3, n=800)
    gt = random_poses(rng, 3)
    pred = compose(random_poses(rng, 3, max_deg=6.0, min_deg=2.0), gt)
    m = jax_metrics.compute_metrics(gt, pred, src, ref, 0.6, 5.0, mask_src=mask, mask_ref=mask)
    m = {k: np.asarray(v) for k, v in m.items()}
    summary = metrics.summarize_metrics(m)
    assert summary == jax_metrics.summarize_metrics(m)
    assert list(summary) == ["r_rmse", "r_mae", "t_rmse", "t_mae", "err_r_deg_mean",
                             "err_r_deg_rmse", "err_t_mean", "err_t_rmse", "succ",
                             "chamfer_dist"]
    lines = []
    for fn in (metrics.print_metrics, jax_metrics.print_metrics):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="metrics-test"):
            fn(logging.getLogger("metrics-test"), summary, title="Evaluation result (iter 1)")
        lines.append([r.getMessage() for r in caplog.records])
    assert lines[0] == lines[1] and len(lines[0]) == 7
