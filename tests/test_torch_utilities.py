"""The port's utility surface against the JAX package on the same seeded
numpy inputs, on the CPU: the feature distances and the tiled reduction
(ops/distance.py), `weighted_kabsch_soft`, Sinkhorn, PointNet++ sampling
and grouping, the chamfer losses and their gradients, correspondence
RANSAC with a validity mask and feature-matching RANSAC (JAX's draws
passed in as `picks`), the on-device radius matches and voxel grid, the
Morton and Hilbert codes, the SE(3) helpers and the composable sample
transforms.

Tolerances and why:
- pure data movement and integer results (PointNet++ indices, Morton and
  Hilbert codes, voxel slots and masks, radius-match pairs, the transforms
  under one np.random.Generator, `to_4x4`, `so3.transform`,
  `from_xyzquat`): equal;
- float32 sums in another order (feature distances, `pairwise_dist_chunked`,
  Sinkhorn, the chamfer values, the voxel means, `transform_cf`,
  `rotate`): 1e-5 relative (1e-5 of the terms' scale for the norm
  expansion's distances, whose cancellation leaves absolute rounding);
- the chamfer gradients: 1e-5 of the largest entry;
- Kabsch solves (`weighted_kabsch_soft`, RANSAC's transforms): 1e-5; their
  gradients 1e-4 of the largest entry (the SVD adjoint divides by
  differences of squared singular values); RANSAC's inlier fraction within
  an ulp (XLA's float32 division on the CPU is not always correctly
  rounded).
The radius matches are held against JAX where both packages' KNN rank the
same neighbours: JAX ranks by the norm expansion, the port by direct
differences, so pairs may differ only on rows where two candidates, or a
candidate and the radius, are within 1e-5 of the terms' scale; against an
exact float64 search they are held without exception.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsir_tpu.data import transforms as jax_transforms
from deepsir_tpu.losses import chamfer as jax_chamfer
from deepsir_tpu.math import se3 as jax_se3, se3_np as jax_se3_np, so3 as jax_so3
from deepsir_tpu.ops import distance as jax_distance, morton as jax_morton
from deepsir_tpu.ops import pointnet as jax_pointnet, ransac as jax_ransac
from deepsir_tpu.ops import radius_match as jax_radius_match, voxel as jax_voxel
from deepsir_tpu.ops.sinkhorn import compute_affinity as jax_affinity, sinkhorn as jax_sinkhorn
from deepsir_tpu.ops.svd3 import weighted_kabsch_soft as jax_kabsch_soft

import chip_smoke
from deepsir_tpu_torch import losses, ops
from deepsir_tpu_torch.data import transforms
from deepsir_tpu_torch.losses import chamfer
from deepsir_tpu_torch.math import se3, se3_np, so3
from deepsir_tpu_torch.ops import distance, morton, pointnet, radius_match, ransac, voxel
from deepsir_tpu_torch.ops.sinkhorn import compute_affinity, sinkhorn
from deepsir_tpu_torch.ops.svd3 import weighted_kabsch_soft

RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def cloud(seed, n, scale=1.0, c=3):
    return normal(seed, n, c, scale=scale)


def rigid(seed, deg=30.0, trans=0.5):
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    g = np.zeros((3, 4), np.float32)
    g[:, :3] = Rotation.from_rotvec(axis / np.linalg.norm(axis) * np.deg2rad(deg)).as_matrix()
    g[:, 3] = rng.uniform(-trans, trans, 3)
    return g


def close(got, want, rtol=RTOL, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rtol * (np.abs(want).max() if scale is None else scale)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


# ------------------------------------------------------- the public surface

def test_ops_and_losses_export_what_jax_exports():
    import deepsir_tpu.losses as jax_losses
    import deepsir_tpu.ops as jax_ops
    for port, jax_mod in ((ops, jax_ops), (losses, jax_losses)):
        names = {n for n in vars(jax_mod) if not n.startswith("_")
                 and callable(getattr(jax_mod, n))}
        assert names <= set(vars(port)), sorted(names - set(vars(port)))


# ------------------------------------------------------------ distances

@pytest.mark.parametrize("metric", ["l2", "euclidean", "angle"])
def test_match_features_equals_jax(metric):
    a, b = normal(0, 2, 150, 16), normal(1, 2, 170, 16)
    got = distance.match_features(t(a), t(b), metric).numpy()
    want = np.asarray(jax_distance.match_features(jnp.asarray(a), jnp.asarray(b), metric))
    terms = (a * a).sum(-1).max() + (b * b).sum(-1).max()
    close(got, want, scale={"l2": terms, "euclidean": np.sqrt(terms), "angle": np.pi}[metric])


@pytest.mark.parametrize("what", ["min", "argmin_and_min"])
def test_pairwise_dist_chunked_equals_jax(what):
    """Tiles of 96 rows over 250 (the last tile ragged; JAX pads it and
    drops the rows past N); the reduce maps a tile to (chunk,) or
    (chunk, 2)."""
    a, b = cloud(2, 250, c=8), cloud(3, 300, c=8)
    if what == "min":
        fns = (lambda d: d.amin(-1), lambda d: jnp.min(d, -1))
    else:
        fns = (lambda d: torch.stack([d.argmin(-1).float(), d.amin(-1)], -1),
               lambda d: jnp.stack([jnp.argmin(d, -1).astype(jnp.float32), jnp.min(d, -1)], -1))
    got = distance.pairwise_dist_chunked(t(a), t(b), fns[0], chunk=96).numpy()
    want = np.asarray(jax_distance.pairwise_dist_chunked(jnp.asarray(a), jnp.asarray(b), fns[1],
                                                         chunk=96))
    terms = (a * a).sum(-1).max() + (b * b).sum(-1).max()
    if what != "min":
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        got, want = got[:, 1], want[:, 1]
    close(got, want, scale=terms)


def test_nearest_square_distance_is_the_metrics_minimum_with_a_gradient():
    """The metrics' minimum carries no gradient; the chamfer losses' has the
    same value bit for bit, and the expansion's gradient at each row's
    nearest point (checked against autograd through the full matrix)."""
    a = t(cloud(4, 64)).requires_grad_()
    b = t(cloud(5, 80)).requires_grad_()
    assert not distance.min_square_distance(a, b).requires_grad
    d = distance.nearest_square_distance(a, b, chunk=16)
    torch.testing.assert_close(d, distance.min_square_distance(a, b, chunk=16), rtol=0, atol=0)
    probe = t(cloud(6, 64)[:, 0])
    grads = torch.autograd.grad((d * probe).sum(), (a, b))
    full = torch.autograd.grad((distance.square_distance(a, b).amin(-1) * probe).sum(), (a, b))
    for got, want in zip(grads, full):
        close(got.numpy(), want.numpy())


# ---------------------------------------------------------- the chamfer losses

CHAMFER_N = (300, 260)


def _chamfer_inputs(weighted):
    a = normal(6, 2, CHAMFER_N[0], 3)
    b = normal(7, 2, CHAMFER_N[1], 3)
    if not weighted:
        return a, b
    rng = np.random.default_rng(8)
    return (a, b, rng.uniform(size=a.shape[:2]).astype(np.float32),
            rng.uniform(size=b.shape[:2]).astype(np.float32))


@pytest.mark.parametrize("form", ["single", "plain", "weighted"])
def test_chamfer_values_and_grads_equal_jax(form):
    """The float32 value within 1e-5 relative of JAX's; the grads of every
    input, both packages in float64 (JAX under x64), within 1e-10 of their
    largest entry. (In float32 a row's grad carries the norm expansion's
    rounding of its distance d amplified by |a|^2 + |b|^2 over d, up to
    1e-3 relative on these clouds, in either package.) The plain forms
    reduce in tiles: the grad flows through each tile's row minimum."""
    inputs = _chamfer_inputs(form == "weighted")
    port_fn, jax_fn = {"single": (chamfer.single_side_chamfer, jax_chamfer.single_side_chamfer),
                       "plain": (chamfer.chamfer_loss, jax_chamfer.chamfer_loss),
                       "weighted": (chamfer.chamfer_loss, jax_chamfer.chamfer_loss)}[form]
    close(port_fn(*map(t, inputs)).item(), float(jax_fn(*map(jnp.asarray, inputs))))
    args = [t(x.astype(np.float64)).requires_grad_() for x in inputs]
    port_fn(*args).backward()
    with jax.enable_x64(True):
        grads = jax.jit(jax.grad(jax_fn, argnums=tuple(range(len(inputs)))))(
            *(jnp.asarray(x, jnp.float64) for x in inputs))
        for arg, g in zip(args, grads):
            assert g.dtype == jnp.float64
            close(arg.grad.numpy(), g, rtol=1e-10)


def test_chamfer_reduces_in_tiles_of_the_metric_chunk():
    """N past one 2048-row tile: the tiled loss equals the one built from
    the full distance matrix."""
    a, b = t(cloud(9, 2100)), t(cloud(10, 700))
    full = torch.sqrt(distance.square_distance(a, b).amin(-1) + 1e-12).mean() + \
        torch.sqrt(distance.square_distance(b, a).amin(-1) + 1e-12).mean()
    close(chamfer.chamfer_loss(a, b).item(), full.item())
    assert losses.chamfer_loss is chamfer.chamfer_loss


# ---------------------------------------------- Kabsch over a soft assignment

def test_weighted_kabsch_soft_and_its_grad_equal_jax():
    """The transform within 1e-5 of JAX's, and its grad with respect to the
    soft assignment within 1e-5 of the largest entry (measured 2.8e-7; the
    SVD adjoint divides by differences of squared singular values, so the
    cloud is anisotropic). The assignment concentrates on the true partners;
    the forward also with one row all zero. The grad is taken without it:
    there the weight sits on the kink of the solve's |w|, whose derivative
    JAX takes as 1 and torch as 0 (0.0169 against 0.0117 on that row)."""
    src = normal(12, 2, 64, 3) * np.array([3.0, 2.0, 1.0], np.float32)
    g = rigid(13)
    tgt = np.concatenate([src @ g[:, :3].T + g[:, 3], normal(14, 2, 16, 3)], 1)
    moved = src @ g[:, :3].T + g[:, 3]
    weights = np.exp(-((moved[:, :, None] - tgt[:, None]) ** 2).sum(-1) / 0.5).astype(np.float32)
    zeroed = weights.copy()
    zeroed[0, 5] = 0.0
    probe = normal(15, 2, 3, 4)

    def jax_fn(w):
        out, bad = jax_kabsch_soft(jnp.asarray(src), jnp.asarray(tgt), w)
        return jnp.sum(out * jnp.asarray(probe)), (out, bad)
    value_and_grad = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))
    got, bad = weighted_kabsch_soft(t(src), t(tgt), t(zeroed))
    (_, (want, want_bad)), _ = value_and_grad(jnp.asarray(zeroed))
    close(got.numpy(), want, scale=1.0)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(want_bad))
    w = t(weights).requires_grad_()
    (weighted_kabsch_soft(t(src), t(tgt), w)[0] * t(probe)).sum().backward()
    close(w.grad.numpy(), value_and_grad(jnp.asarray(weights))[1])


# --------------------------------------------------------------- Sinkhorn

@pytest.mark.parametrize("alpha", ["scalar", "per_batch"])
def test_compute_affinity_equals_jax(alpha):
    rng = np.random.default_rng(16)
    beta = rng.uniform(1, 5, 3).astype(np.float32)
    dist = rng.uniform(size=(3, 40, 50)).astype(np.float32)
    a = 0.5 if alpha == "scalar" else rng.uniform(size=3).astype(np.float32)
    got = compute_affinity(t(beta), t(dist), a if alpha == "scalar" else t(a))
    want = jax_affinity(jnp.asarray(beta), jnp.asarray(dist),
                        a if alpha == "scalar" else jnp.asarray(a))
    close(got.numpy(), want)


@pytest.mark.parametrize("slack", [True, False])
def test_sinkhorn_equals_jax(slack):
    log_alpha = normal(17, 2, 60, 70, scale=3.0)
    got = sinkhorn(t(log_alpha), n_iters=5, slack=slack).numpy()
    want = np.asarray(jax_sinkhorn(jnp.asarray(log_alpha), n_iters=5, slack=slack))
    assert got.shape == (2, 60, 70)
    close(got, want, scale=np.abs(want).max())


# ------------------------------------------------------------ PointNet++

def test_farthest_point_sample_equals_jax():
    xyz = normal(18, 3, 500, 3)
    got = pointnet.farthest_point_sample(t(xyz), 64).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pointnet.farthest_point_sample(
        jnp.asarray(xyz), 64)))
    assert (got[:, 0] == 0).all() and all(len(set(r)) == 64 for r in got)


def test_farthest_point_sample_takes_the_first_of_tied_rows():
    """Duplicate rows: argmax's first maximum, in both packages."""
    xyz = np.repeat(cloud(19, 40), 3, axis=0)[None]
    got = pointnet.farthest_point_sample(t(xyz), 30).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pointnet.farthest_point_sample(
        jnp.asarray(xyz), 30)))
    assert (got % 3 == 0).all()


def test_query_ball_point_equals_jax():
    """Stable order on equal distances (duplicated points), the group_first
    fill, and an empty ball."""
    xyz = np.concatenate([cloud(20, 400), cloud(20, 400)[:50]])[None]
    centers = np.concatenate([xyz[:, :40], np.full((1, 1, 3), 50.0, np.float32)], 1)
    got = pointnet.query_ball_point(0.4, 16, t(xyz), t(centers)).numpy()
    want = np.asarray(jax_pointnet.query_ball_point(0.4, 16, jnp.asarray(xyz),
                                                    jnp.asarray(centers)))
    np.testing.assert_array_equal(got, want)
    assert (got[0, -1] == 0).all()                 # the empty ball
    assert (got[:, :40] != got[:, :40, :1]).any(-1).all()


def test_sample_and_group_equals_jax():
    xyz = normal(21, 2, 512, 3)
    feats = normal(22, 2, 512, 5)
    new_xyz, grouped = pointnet.sample_and_group(64, 0.6, 16, t(xyz), t(feats))
    want_xyz, want = jax_pointnet.sample_and_group(64, 0.6, 16, jnp.asarray(xyz),
                                                   jnp.asarray(feats))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    assert grouped.shape == (2, 64, 16, 8)
    close(grouped.numpy(), want)
    np.testing.assert_array_equal(pointnet.index_points(t(xyz), t(np.array([[3, 1]] * 2))),
                                  xyz[:, [3, 1]])


# -------------------------------------------------------------- RANSAC

def _putative(seed, n=400, outliers=0.4):
    """A cloud, its rigid motion and correspondences of which a share are
    wrong."""
    src = cloud(seed, n)
    g = rigid(seed + 1)
    ref = (src @ g[:, :3].T + g[:, 3]).astype(np.float32)
    match = np.arange(n)
    bad = np.random.default_rng(seed + 2).random(n) < outliers
    match[bad] = np.random.default_rng(seed + 3).integers(0, n, bad.sum())
    return src, ref, np.stack([np.arange(n), match], 1).astype(np.int32), g


def test_ransac_correspondence_with_a_mask_equals_jax():
    """Padded pairs (the last 100, pointing at row -1) weigh nothing in a
    sample's solve, count as no inlier, and are left out of the polish and
    of the fraction; samples of 4 pairs; with JAX's threefry draws passed
    in as `picks`. (The feature-matching test below takes the default
    3-pair samples without a mask.)"""
    src, ref, corres, g = _putative(23)
    valid = np.arange(len(corres)) < 300
    corres[~valid] = -1
    m = 4
    key = jax.random.PRNGKey(5)
    picks = np.asarray(jax.random.randint(key, (256, m), 0, len(corres)))
    want, want_frac = jax_ransac.ransac_correspondence(
        key, jnp.asarray(src), jnp.asarray(ref), jnp.asarray(corres), 0.05, 256,
        valid=jnp.asarray(valid), min_sample=m)
    got, frac = ransac.ransac_correspondence(t(src), t(ref), t(corres).long(), 0.05,
                                             picks=t(picks), valid=t(valid), min_sample=m)
    close(got.numpy(), want, scale=1.0)
    np.testing.assert_allclose(float(frac), float(want_frac), rtol=2.4e-7)
    assert abs(got.numpy() - g).max() < 1e-3


def test_ransac_feature_matching_equals_jax():
    """Descriptors: the clouds' own coordinates lifted to 16 channels with
    noise; the one-way nearest descriptors equal JAX's, and with JAX's draws
    the transform equals JAX's."""
    src, ref, _, g = _putative(24, n=300, outliers=0.0)
    lift = np.random.default_rng(25).normal(size=(3, 16)).astype(np.float32)
    feat_src = src @ lift + 0.05 * normal(26, 300, 16)
    feat_ref = src @ lift + 0.05 * normal(27, 300, 16)
    key = jax.random.PRNGKey(0)
    picks = np.asarray(jax.random.randint(key, (512, 3), 0, 300))
    want, want_frac = jax_ransac.ransac_feature_matching(
        key, jnp.asarray(src), jnp.asarray(ref), jnp.asarray(feat_src), jnp.asarray(feat_ref),
        0.05, 512)
    got, frac = ransac.ransac_feature_matching(t(src), t(ref), t(feat_src), t(feat_ref), 0.05,
                                               picks=t(picks))
    np.testing.assert_array_equal(
        distance.nearest_neighbour_index(t(feat_src)[None], t(feat_ref)[None])[0].numpy(),
        np.asarray(jax_distance.nearest_neighbour_index(jnp.asarray(feat_src),
                                                        jnp.asarray(feat_ref))))
    close(got.numpy(), want, scale=1.0)
    np.testing.assert_allclose(float(frac), float(want_frac), rtol=2.4e-7)
    assert abs(got.numpy() - g).max() < 1e-3
    drawn = ransac.ransac_feature_matching(t(src), t(ref), t(feat_src), t(feat_ref), 0.05, 512,
                                           generator=torch.Generator().manual_seed(1))[0]
    assert abs(drawn.numpy() - g).max() < 1e-3


# ------------------------------------------------------- radius matches

def _exact_pairs(src_t, tgt, radius, k):
    """Each row's k nearest by float64 distance (ties to the lower index)
    that lie within the radius, in (row, distance) order."""
    d = ((src_t[:, None, :].astype(np.float64) - tgt[None].astype(np.float64)) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    rows = np.repeat(np.arange(len(src_t)), order.shape[1])
    cols = order.reshape(-1)
    keep = d[rows, cols] < radius * radius
    return np.stack([rows[keep], cols[keep]], 1), d


RADIUS_CASES = {"fits": (600, 0.3, 8, 4800), "capacity": (600, 0.3, 8, 400),
                "k_cap": (600, 0.6, 4, 2400)}


@pytest.mark.parametrize("case", list(RADIUS_CASES))
def test_radius_matches_equal_jax_and_an_exact_search(case):
    """fits: every in-radius pair within k and capacity (the rest padded
    with -1); capacity: more valid pairs than capacity (cut, num_valid =
    capacity); k_cap: more in-radius targets than k per point."""
    n, radius, k, cap = RADIUS_CASES[case]
    src, tgt, g = cloud(28, n), cloud(29, n + 37), rigid(30, trans=0.1)
    pairs, num = radius_match.radius_matches(t(src), t(tgt), t(g), radius, k_per_point=k,
                                             capacity=cap)
    want, want_num = jax_radius_match.radius_matches(jnp.asarray(src), jnp.asarray(tgt),
                                                     jnp.asarray(g), radius, k_per_point=k,
                                                     capacity=cap)
    pairs, want = pairs.numpy(), np.asarray(want)
    exact, d = _exact_pairs(src @ g[:, :3].T + g[:, 3], tgt, radius, k)
    total = len(exact)
    assert num.dim() == 0 and int(num) == min(total, cap)
    np.testing.assert_array_equal(pairs[:int(num)], exact[:cap])
    assert (pairs[int(num):] == -1).all()
    assert {"fits": total < cap, "capacity": total > cap, "k_cap": total < cap}[case]
    if case == "k_cap":
        assert ((d < radius * radius).sum(1) > k).any()
    # against JAX: equal, but for rows whose candidates JAX's norm
    # expansion ranks or tests otherwise (near ties of the terms' scale)
    assert int(want_num) == int(num) or abs(int(want_num) - int(num)) <= 2
    differ = np.unique(np.concatenate([pairs[:, 0][(pairs != want).any(1) & (pairs[:, 0] >= 0)],
                                       want[:, 0][(pairs != want).any(1) & (want[:, 0] >= 0)]]))
    assert len(differ) <= 2, differ
    for row in differ:
        near = np.sort(d[row])[:k + 1]
        terms = (src[row] ** 2).sum() + (tgt ** 2).sum(1).max()
        gaps = np.abs(np.concatenate([np.diff(near), near - radius * radius]))
        assert gaps.min() <= 1e-5 * terms, (row, gaps.min())


def test_radius_matches_fewer_candidates_than_capacity():
    """N * k below capacity: the pair list is padded to capacity."""
    src, tgt = cloud(31, 50), cloud(32, 60)
    pairs, num = radius_match.radius_matches(t(src), t(tgt), t(np.eye(4, dtype=np.float32)), 0.5,
                                             k_per_point=4, capacity=300)
    exact, _ = _exact_pairs(src, tgt, 0.5, 4)
    assert pairs.shape == (300, 2) and int(num) == len(exact)
    np.testing.assert_array_equal(pairs[:len(exact)].numpy(), exact)
    assert (pairs[len(exact):] == -1).all()


# ---------------------------------------------------------- the voxel grid

VOXEL_CASES = {"all": (None, 2000), "padded": (700, 2000), "overflow": (None, 150)}


@pytest.mark.parametrize("case", list(VOXEL_CASES))
def test_voxel_downsample_equals_jax(case):
    """Means within 1e-5 relative, masks and slots equal, with padding rows
    (valid False, at garbage coordinates) and voxels past capacity."""
    real, cap = VOXEL_CASES[case]
    pts = np.concatenate([cloud(33, 1000, scale=3.0), cloud(34, 1000, c=2)], 1)
    valid = None
    if real is not None:
        valid = np.arange(1000) < real
        pts[~valid] = normal(35, (~valid).sum(), 5, scale=1e3)
    got, mask = voxel.voxel_downsample(t(pts), 0.5, cap, None if valid is None else t(valid))
    want, want_mask = jax_voxel.voxel_downsample(jnp.asarray(pts), 0.5, cap,
                                                 None if valid is None else jnp.asarray(valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    close(got.numpy(), want)
    occupied = int(mask.sum())
    host = voxel.voxel_downsample_np(pts if valid is None else pts[valid], 0.5)
    assert occupied == min(len(host), cap)
    if case != "overflow":
        close(got.numpy()[:occupied], host)
    assert not mask[occupied:].any()


# ------------------------------------------------------------ curve codes

@pytest.mark.parametrize("padded", [False, True])
def test_morton_code_equals_jax(padded):
    """Equal but for rows that sit at a cell edge: XLA's float32 division on
    the CPU is not always correctly rounded, so JAX's 1023 / (hi - lo) may
    be an ulp off the port's and move a coordinate within a few ulps of an
    edge into the next cell (chip_smoke.morton_edge_flips: one cell along
    the axes that differ, within one float32 ulp of the edge; measured 2 of
    1400 rows, each a cloud's largest coordinate, 1023 in float64 and an ulp
    below it in JAX's float32)."""
    xyz = normal(36, 2, 700, 3, scale=5.0)
    valid = None
    if padded:
        valid = np.arange(700)[None] < np.array([[650], [700]])
        xyz[0, 650:] = 1e4
    got = morton.morton_code(t(xyz), None if valid is None else t(valid))
    want = jax_morton.morton_code(jnp.asarray(xyz), None if valid is None else jnp.asarray(valid))
    assert got.dtype == torch.int32
    flips = chip_smoke.morton_edge_flips(xyz, valid, got.numpy(), np.asarray(want))
    assert flips <= 0.01 * got.numel()
    if padded:
        assert (got[0, 650:] == 2 ** 30).all() and (got < 2 ** 30).sum() == 1350


@pytest.mark.parametrize("padded", [False, True])
def test_hilbert_code_and_order_equal_jax(padded):
    xyz = cloud(37, 900, scale=4.0)
    valid = (np.arange(900) < 850) if padded else None
    np.testing.assert_array_equal(morton.hilbert_code_np(xyz, valid),
                                  jax_morton.hilbert_code_np(xyz, valid))
    order = morton.hilbert_order_np(xyz, valid)
    np.testing.assert_array_equal(order, jax_morton.hilbert_order_np(xyz, valid))
    assert sorted(order) == list(range(900))


# ------------------------------------------------------------ SE(3) helpers

def test_se3_helpers_equal_jax():
    g = np.stack([rigid(38), rigid(39)])
    pts = normal(40, 2, 50, 3)
    close(se3.transform_cf(t(g), t(pts).transpose(1, 2)).numpy(),
          jax_se3.transform_cf(jnp.asarray(g), jnp.asarray(pts).swapaxes(1, 2)))
    close(se3.rotate(t(g), t(pts)).numpy(), jax_se3.rotate(jnp.asarray(g), jnp.asarray(pts)))
    for mat in (g, np.asarray(jax_se3_np.to_4x4(g), np.float32)):
        np.testing.assert_array_equal(se3.to_4x4(t(mat)).numpy(),
                                      np.asarray(jax_se3.to_4x4(jnp.asarray(mat))))
    np.testing.assert_array_equal(so3.transform(g[0], pts[0]), jax_so3.transform(g[0], pts[0]))
    xyzquat = np.array([0.3, -1.2, 2.0, 0.1, -0.4, 0.2, 0.8])
    np.testing.assert_array_equal(se3_np.from_xyzquat(xyzquat), jax_se3_np.from_xyzquat(xyzquat))
    np.testing.assert_array_equal(se3_np.identity(), jax_se3_np.identity())


# -------------------------------------------------------- sample transforms

def _pipeline(mod, crop):
    return [mod.SplitSourceRef(), mod.RandomCrop(crop), mod.Resampler(300),
            mod.RandomJitter(), mod.RandomTransformSE3(45.0, 0.5), mod.ShufflePoints()]


@pytest.mark.parametrize("crop", [[0.7], [0.7, 0.6], [1.0, 1.0]])
def test_sample_transforms_equal_jax(crop):
    """The composed transforms under one np.random.Generator seed give the
    same sample, key for key; a "crop_proportion" sizes the resampled
    clouds."""
    samples = []
    for mod in (transforms, jax_transforms):
        sample = {"points": cloud(41, 500, c=4), "crop_proportion": [0.7, 0.6]}
        rng = np.random.default_rng(42)
        for tr in _pipeline(mod, crop):
            sample = tr(sample, rng)
        samples.append(sample)
    got, want = samples
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    assert got["points_src"].shape == (210, 4) and got["points_ref"].shape == (180, 4)


def test_single_cloud_transforms_equal_jax():
    """A sample of one cloud ("points"): resampled, jittered, moved and
    shuffled alike; jitter and the rigid motion also on a bare array."""
    outs = []
    for mod in (transforms, jax_transforms):
        rng = np.random.default_rng(43)
        sample = {"points": cloud(44, 200)}
        for tr in (mod.Resampler(250), mod.RandomJitter(), mod.RandomTransformSE3(),
                   mod.ShufflePoints()):
            sample = tr(sample, rng)
        bare = mod.RandomTransformSE3(30.0)(mod.RandomJitter()(cloud(45, 20), rng), rng)
        outs.append((sample["points"], *bare))
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------- chip_smoke.py's phase

def test_chip_smoke_utilities_phase_on_the_cpu():
    """chip_smoke.py's "utilities" phase at 512 points on the CPU (the plain
    versions, so no launch counts and no yardstick timing): every check of
    the phase runs and holds, the CPU against itself."""
    launches, record = chip_smoke.check_utilities(torch, torch.device("cpu"), n=512)
    assert launches == dict.fromkeys(chip_smoke.COUNTED, 0)
    assert record["ransac"]["k2_near_ties"]["rows"] == 0
    assert record["ransac"]["transform_err"] == 0.0
    radius = record["radius_matches"]
    assert 0 < radius["num_valid"] == radius["valid_pairs"] <= chip_smoke.UTIL_CAPACITY
    assert record["groups"]["fps_steps_equal"] == record["groups"]["centers"] == 128
    assert record["soft"]["pose_err"] < 1e-2
    for key in ("chamfer", "chamfer_weighted"):
        assert record[key]["float64_err"] == 0.0
