"""The port's data layer against the JAX package's, on the CPU: the same
flags and seed give bit-equal Synthetic batches (every array, masks,
labels, match lists and Morton order included) over two shuffled epochs
with 1 and 4 loader threads, with the JAX package's optional C++ library
off; with it on, the match lists are the same sets and every other value
is within 1e-4. `math/rand.py`, `data/transforms.py` and the host ops
(voxel grid, radius matches, ICP) are bit-equal on seeded generators with
the library off, and within 1e-4 of it on."""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import numpy as np
import pytest

import deepsir_tpu.native as jax_native
from deepsir_tpu import config as jax_config
from deepsir_tpu.data import transforms as jax_t
from deepsir_tpu.data.base import Loader as JaxLoader
from deepsir_tpu.data.datasets import get_test_dataset as jax_test_set
from deepsir_tpu.data.datasets import get_train_datasets as jax_train_sets
from deepsir_tpu.math import rand as jax_rand
from deepsir_tpu.ops import icp as jax_icp
from deepsir_tpu.ops import radius_match as jax_rm
from deepsir_tpu.ops import voxel as jax_voxel
from deepsir_tpu_torch import config as port_config
from deepsir_tpu_torch.data import transforms as port_t
from deepsir_tpu_torch.data.base import Loader as PortLoader
from deepsir_tpu_torch.data.datasets import get_test_dataset as port_test_set
from deepsir_tpu_torch.data.datasets import get_train_datasets as port_train_sets
from deepsir_tpu_torch.math import rand as port_rand
from deepsir_tpu_torch.ops import icp as port_icp
from deepsir_tpu_torch.ops import radius_match as port_rm
from deepsir_tpu_torch.ops import voxel as port_voxel

BASE = ("--dataset_type Synthetic --num_points 256 --feat_len 3 --synthetic_train_size 8 "
        "--synthetic_eval_size 4 -bs 4 --rot_mag 30 --trans_mag 1.0").split()
OPTIONS = {"default": [], "morton": ["--pyramid_order", "morton"],
           "match_lists": ["--gt_match_lists", "true", "--thres_radius", "0.9"],
           "partial": ["--synthetic_p_keep", "0.7", "--synthetic_noise", "0.02"]}


@pytest.fixture
def native_off(monkeypatch):
    """The JAX package on its numpy/scipy paths, as the port always is."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)


def _configs(argv):
    return tuple(pkg.config_from_args(pkg.train_argument_parser().parse_args(argv))
                 for pkg in (jax_config, port_config))


def _loader_pairs(argv, workers):
    """(JAX loader, port loader) over the train (shuffled, drop_last), val
    and test splits."""
    jc, pc = _configs(argv)
    (jt, jv), (pt, pv) = jax_train_sets(jc), port_train_sets(pc)
    for jd, pd, shuffle in ((jt, pt, True), (jv, pv, False),
                            (jax_test_set(jc), port_test_set(pc), False)):
        yield tuple(cls(ds, 4, shuffle=shuffle, seed=3, num_workers=workers, drop_last=shuffle)
                    for cls, ds in ((JaxLoader, jd), (PortLoader, pd)))


def _batches(argv, workers, epochs=2):
    for jl, pl in _loader_pairs(argv, workers):
        for _ in range(epochs):
            got = list(pl)
            want = list(jl)
            assert len(got) == len(want) == len(pl) > 0
            yield from zip(want, got)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_synthetic_batches_are_bit_equal(native_off, option, workers):
    keys = set()
    for want, got in _batches(BASE + OPTIONS[option], workers):
        assert list(got) == list(want)
        for key, value in want.items():
            if key == "meta":
                assert got[key] == value
            else:
                assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
        keys |= set(want)
    assert {"labels_src", "mask_src"} <= keys
    assert ("matches" in keys) == (option == "match_lists")


def test_match_lists_with_the_native_library(monkeypatch):
    """The JAX package's C++ radius search: the same pairs in another order;
    everything else within 1e-4 (equal, in fact, for Synthetic)."""
    if not jax_native.available():
        pytest.skip("the JAX package's native library does not build here")
    for want, got in _batches(BASE + OPTIONS["match_lists"], 2, epochs=1):
        for key, value in want.items():
            if key == "matches":
                for w, g, n in zip(value, got[key], want["num_matches"]):
                    assert set(map(tuple, w[:n])) == set(map(tuple, g[:n]))
            elif key != "meta":
                assert np.allclose(got[key], value, atol=1e-4, rtol=0), key


def _cloud(seed, n=3000, labels=False):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, 5, size=(n, 4)).astype(np.float32)
    if labels:
        pts[:, 3] = rng.integers(0, 20, n)
    return pts


@pytest.mark.parametrize("label_column", [None, 3])
def test_voxel_downsample_np(native_off, label_column):
    pts = _cloud(0, labels=label_column is not None)
    assert np.array_equal(port_voxel.voxel_downsample_np(pts, 0.5, label_column),
                          jax_voxel.voxel_downsample_np(pts, 0.5, label_column))


def test_host_ops_against_the_native_library():
    """Values within 1e-4, match sets equal, row order free."""
    if not jax_native.available():
        pytest.skip("the JAX package's native library does not build here")
    pts = _cloud(1)
    got = port_voxel.voxel_downsample_np(pts, 0.5)
    want = jax_voxel.voxel_downsample_np(pts, 0.5)

    def rows(a):
        return a[np.lexsort(a.T[::-1])]
    assert got.shape == want.shape and np.allclose(rows(got), rows(want), atol=1e-4)
    src, tgt, pose = _icp_case()
    assert np.allclose(port_icp.icp_np(src, tgt, 0.5, init=np.eye(4)),
                       jax_icp.icp_np(src, tgt, 0.5, init=np.eye(4)), atol=1e-4)
    got = port_rm.radius_matches_np(src, tgt, pose, 0.3)
    want = jax_rm.radius_matches_np(src, tgt, pose, 0.3)
    assert set(map(tuple, got)) == set(map(tuple, want)) and len(got) == len(want)


def _icp_case():
    rng = np.random.default_rng(2)
    src = rng.uniform(-5, 5, size=(2000, 3))
    pose = jax_rand.random_se3_euler(rng, 3.0, 0.1)
    tgt = (src @ pose[:3, :3].T + pose[:3, 3] + rng.normal(scale=0.01, size=src.shape))
    return src.astype(np.float32), tgt.astype(np.float32), pose


def test_icp_np_and_radius_matches(native_off):
    src, tgt, pose = _icp_case()
    for init in (None, np.eye(3, 4)):
        assert np.array_equal(port_icp.icp_np(src, tgt, 0.5, init=init),
                              jax_icp.icp_np(src, tgt, 0.5, init=init))
    assert np.array_equal(port_rm.radius_matches_np(src, tgt, pose, 0.3),
                          jax_rm.radius_matches_np(src, tgt, pose, 0.3))
    empty = port_rm.radius_matches_np(src, tgt + 100.0, pose, 0.3)
    assert empty.shape == (0, 2)
    for matches in (jax_rm.radius_matches_np(src, tgt, pose, 0.3), np.zeros((0, 2), np.int32)):
        for cap in (5, 100000):
            got, want = port_rm.pad_matches(matches, cap), jax_rm.pad_matches(matches, cap)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1]


RAND_CALLS = [
    ("uniform_2_sphere", ()), ("uniform_2_sphere", (7,)), ("random_rotation_z", (60.0,)),
    ("random_se3_euler", (30.0, 1.0, 0.1)), ("random_se3_uniform", (45.0, 0.5)),
]


@pytest.mark.parametrize("name,args", RAND_CALLS, ids=[f"{n}{a}" for n, a in RAND_CALLS])
def test_rand_is_bit_equal(name, args):
    for seed in range(3):
        got = getattr(port_rand, name)(np.random.default_rng(seed), *args)
        want = getattr(jax_rand, name)(np.random.default_rng(seed), *args)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    pts = _cloud(4)
    assert np.array_equal(port_rand.sample_random_trans(np.random.default_rng(0), pts, 90.0),
                          jax_rand.sample_random_trans(np.random.default_rng(0), pts, 90.0))


@pytest.mark.parametrize("n,k", [(100, 100), (300, 100), (100, 250), (100, 40)])
def test_resamplers_are_bit_equal(n, k):
    pts = _cloud(5, n)
    for seed in range(2):
        assert np.array_equal(port_t.resample(np.random.default_rng(seed), pts, k),
                              jax_t.resample(np.random.default_rng(seed), pts, k))
    assert np.array_equal(port_t.fixed_resample(pts, k), jax_t.fixed_resample(pts, k))


def test_transforms_are_bit_equal():
    pts = _cloud(6) * 10
    for seed in range(3):
        for name in ("halfspace_crop",):
            for keep in (0.5, 0.7):
                assert np.array_equal(
                    getattr(port_t, name)(np.random.default_rng(seed), pts, keep),
                    getattr(jax_t, name)(np.random.default_rng(seed), pts, keep))
        assert np.array_equal(port_t.RandomJitter(0.05, 0.1).jitter(np.random.default_rng(seed), pts),
                              jax_t.RandomJitter(0.05, 0.1).jitter(np.random.default_rng(seed), pts))
        for cls, args in (("RandomTransformSE3", (90.0, 0.0)),
                          ("RandomTransformSE3Euler", (30.0, 1.0, 0.1)),
                          ("RandomRotatorZ", (60.0,))):
            got = getattr(port_t, cls)(*args).transform(np.random.default_rng(seed), pts)
            want = getattr(jax_t, cls)(*args).transform(np.random.default_rng(seed), pts)
            for g, w in zip(got, want):
                assert np.array_equal(g, w), cls
    for limits in ((0.0, 50.0, -3.0, 10.0), (3.0, 4.0, -1.0, 1.0)):
        assert np.array_equal(port_t.process_point_cloud(pts, *limits),
                              jax_t.process_point_cloud(pts, *limits))
