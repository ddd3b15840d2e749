"""The port's KITTI / SemanticKITTI, Oxford and 3DMatch readers against the
JAX package's, on small dataset trees the tests write (velodyne .bin,
.label, odometry poses; Oxford npy frames and their index; 3DMatch pickles,
gt.log trajectories and PLY fragments, binary and ascii), with the JAX
package's optional C++ library off. Each package reads its own copy of a
tree (the ground-truth ICP caches are written into it), and every batch of
every split is bit-equal: points, poses, masks, labels, match lists."""
import os
import pickle
import shutil
import struct

import numpy as np
import pytest

import deepsir_tpu.native as jax_native
from deepsir_tpu import config as jax_config
from deepsir_tpu.data.base import Loader as JaxLoader
from deepsir_tpu.data.datasets import get_test_dataset as jax_test_set
from deepsir_tpu.data.datasets import get_train_datasets as jax_train_sets
from deepsir_tpu_torch import config as port_config
from deepsir_tpu_torch.data.base import Loader as PortLoader
from deepsir_tpu_torch.data.datasets import get_test_dataset as port_test_set
from deepsir_tpu_torch.data.datasets import get_train_datasets as port_train_sets
from deepsir_tpu_torch.data.kitti import velo2cam_4x4
from deepsir_tpu_torch.data.threedmatch import TEST_SCENES, read_gt_log, read_ply_xyz
from deepsir_tpu_torch.math import se3_np


@pytest.fixture(autouse=True)
def native_off(monkeypatch):
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)


def _rot_z(ang):
    return np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])


def make_world(rng, n):
    """A ring of points inside the KITTI crop window (r 6..45 m, z -1..6)."""
    r = rng.uniform(6, 45, n)
    th = rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(th), r * np.sin(th), rng.uniform(-1.0, 6.0, n)],
                    1).astype(np.float32)


def write_kitti(root, rng):
    """Drives 0 (train), 6 (val) and 8 (test, 3 m per frame so that frames
    10 m apart exist), 6 frames each, with consistent odometry poses."""
    v2c_t = velo2cam_4x4().T
    (root / "split").mkdir(parents=True)
    for split, drive in (("train", 0), ("val", 6), ("test", 8)):
        (root / "split" / f"{split}_kitti.txt").write_text(f"{drive}\n")
        seq = root / "dataset" / "sequences" / f"{drive:02d}"
        (seq / "velodyne").mkdir(parents=True)
        (seq / "labels").mkdir()
        world = make_world(rng, 3000)
        step = np.eye(4)
        step[:3, :3] = _rot_z(0.03)
        step[:3, 3] = [3.0 if split == "test" else 0.8, 0.2, 0.0]
        poses = []
        for t in range(6):
            m_t = np.linalg.inv(np.linalg.matrix_power(step, t))
            scan = se3_np.transform(m_t, world).astype(np.float32)
            pts = np.concatenate([scan, rng.uniform(size=(len(scan), 1))], 1)
            pts.astype(np.float32).tofile(str(seq / "velodyne" / f"{t:06d}.bin"))
            raw = rng.choice([0, 10, 30, 40, 48, 50, 70, 80], size=len(scan))
            (raw.astype(np.int32) | (3 << 16)).tofile(str(seq / "labels" / f"{t:06d}.label"))
            poses.append((np.linalg.inv(v2c_t) @ np.linalg.inv(m_t).T).T[:3].reshape(-1))
        (root / "dataset" / "poses").mkdir(exist_ok=True)
        np.savetxt(str(root / "dataset" / "poses" / f"{drive:02d}.txt"), np.stack(poses))


def write_oxford(root, rng):
    """A train frame with its index line, and a test pair whose catalogue
    pose is the true one perturbed (for oxford_pose_refine)."""
    from scipy.spatial.transform import Rotation
    train, test = root / "train_np_nofilter", root / "test_models_20k_np_nofilter"
    train.mkdir(parents=True)
    test.mkdir()
    for i in range(3):
        np.save(str(train / f"frame{i}.npy"), make_world(rng, 3000))
    (train / "train_relative.txt").write_text(
        "".join(f"frame{i}.npy | 1 2 | 1 2 3\n" for i in range(3)) + "bad line\n")
    cloud = make_world(rng, 3000)
    gt = np.eye(4)
    gt[:3, :3] = _rot_z(0.1)
    gt[:3, 3] = [1.0, 0.5, 0.1]
    np.save(str(test / "0.npy"), cloud)
    np.save(str(test / "1.npy"), se3_np.transform(gt, cloud).astype(np.float32))
    catalogue = gt.copy()
    catalogue[:3, :3] = Rotation.from_euler("z", 0.1, degrees=True).as_matrix() @ gt[:3, :3]
    catalogue[:3, 3] += [0.03, -0.02, 0.01]
    q = Rotation.from_matrix(catalogue[:3, :3]).as_quat()         # xyzw
    entries = [{"pos_idx": 0, "anc_idx": 1, "t": catalogue[:3, 3],
                "q": np.array([q[3], q[0], q[1], q[2]])}] * 2
    with open(str(test / "groundtruths.pkl"), "wb") as f:
        pickle.dump(entries, f)


def write_ply(path, xyz, binary):
    header = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
              f"element vertex {len(xyz)}", "property float x", "property float y",
              "property float z", "property uchar red", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            for p in xyz:
                f.write(struct.pack("<fffB", *p, 7))
        else:
            f.write("".join(f"{p[0]} {p[1]} {p[2]} 7\n" for p in xyz).encode())


def write_threedmatch(root, rng):
    """Train and val pickles (three fragments, pairs above and below the
    overlap threshold) and every test scene's gt.log with two fragments."""
    tv = root / "3dmatch_train_val"
    tv.mkdir(parents=True)
    for split in ("train", "val"):
        points = {f"scene-{split}/cloud_bin_{i}": rng.uniform(0, 2, (1500, 3))
                  for i in range(3)}
        overlap = {f"scene-{split}/cloud_bin_0@scene-{split}/cloud_bin_1": 0.6,
                   f"scene-{split}/cloud_bin_1@scene-{split}/cloud_bin_2": 0.4,
                   f"scene-{split}/cloud_bin_0@scene-{split}/cloud_bin_2": 0.1}
        with open(tv / f"3DMatch_{split}_0.030_points.pkl", "wb") as f:
            pickle.dump(points, f)
        with open(tv / f"3DMatch_{split}_0.030_overlap.pkl", "wb") as f:
            pickle.dump(overlap, f)
    for k, scene in enumerate(TEST_SCENES):
        (root / "test" / scene).mkdir(parents=True)
        (root / "test" / f"{scene}-evaluation").mkdir()
        pose = np.eye(4)
        pose[:3, :3] = _rot_z(0.2 * k)
        pose[:3, 3] = [0.1 * k, 0.0, 0.05]
        cloud = rng.uniform(0, 2, (1200, 3)).astype(np.float32)
        write_ply(root / "test" / scene / "cloud_bin_0.ply", cloud, binary=k % 2 == 0)
        write_ply(root / "test" / scene / "cloud_bin_1.ply",
                  se3_np.transform(np.linalg.inv(pose), cloud), binary=k % 2 == 1)
        rows = "\n".join(" ".join(f"{v:.9f}" for v in r) for r in pose)
        (root / "test" / f"{scene}-evaluation" / "gt.log").write_text(f"0 1 2\n{rows}\n")


WRITERS = {"KITTI": write_kitti, "Oxford": write_oxford, "3DMatch": write_threedmatch}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Each dataset's tree, once per package."""
    out = {}
    for k, (name, write) in enumerate(WRITERS.items()):
        root = tmp_path_factory.mktemp(name.lower())
        write(root / "jax", np.random.default_rng(k))
        shutil.copytree(root / "jax", root / "port")
        out[name] = root
    return out


def _flags(dataset, root):
    return (f"--dataset_type {dataset} --dataset_path {root} --num_points 512 --num_knn 8 "
            "--gt_match_lists true --oxford_pose_refine true -bs 2").split()


def _compare(want, got):
    assert list(got) == list(want)
    for key, value in want.items():
        if key == "meta":
            assert got[key] == value
        else:
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key


@pytest.mark.parametrize("dataset", list(WRITERS))
def test_reader_batches_are_bit_equal(trees, dataset):
    root = trees[dataset]
    jc, pc = (pkg.config_from_args(pkg.train_argument_parser().parse_args(
        _flags(dataset, root / sub))) for pkg, sub in ((jax_config, "jax"),
                                                       (port_config, "port")))
    (jt, jv), (pt, pv) = jax_train_sets(jc), port_train_sets(pc)
    for jd, pd, shuffle in ((jt, pt, True), (jv, pv, False),
                            (jax_test_set(jc), port_test_set(pc), False)):
        assert len(pd) == len(jd) > 0
        for epoch in range(2 if shuffle else 1):
            jl, pl = (cls(ds, 2, shuffle=shuffle, seed=1, num_workers=2)
                      for cls, ds in ((JaxLoader, jd), (PortLoader, pd)))
            pl.epoch = jl.epoch = epoch
            for want, got in zip(jl, pl):
                _compare(want, got)
    caches = {"KITTI": "icp_opti_pose", "Oxford": "icp_refined_pose"}.get(dataset)
    if caches:
        # each package refined the poses itself, to the same bits
        names = sorted(os.listdir(root / "port" / caches))
        assert names and names == sorted(os.listdir(root / "jax" / caches))
        for n in names:
            assert np.array_equal(np.load(root / "port" / caches / n),
                                  np.load(root / "jax" / caches / n))


def test_ply_and_gt_log_readers(trees):
    from deepsir_tpu.data import threedmatch as jax_tdm
    root = trees["3DMatch"] / "port" / "test"
    for scene in TEST_SCENES[:2]:
        for i in (0, 1):
            path = str(root / scene / f"cloud_bin_{i}.ply")
            got = read_ply_xyz(path)
            assert got.shape == (1200, 3) and np.array_equal(got, jax_tdm.read_ply_xyz(path))
        log = str(root / f"{scene}-evaluation" / "gt.log")
        (i, j, pose), = read_gt_log(log)
        (wi, wj, wpose), = jax_tdm.read_gt_log(log)
        assert (i, j) == (wi, wj) == (0, 1) and np.array_equal(pose, wpose)


def test_semantic_kitti_labels():
    from deepsir_tpu.data import semantic_kitti as jax_sk
    from deepsir_tpu_torch.data import semantic_kitti as port_sk
    raw = np.arange(-3, 300)
    assert np.array_equal(port_sk.remap_labels(raw), jax_sk.remap_labels(raw))
    assert port_sk.LEARNING_MAP == jax_sk.LEARNING_MAP
    assert port_sk.CLASS_NAMES == jax_sk.CLASS_NAMES
