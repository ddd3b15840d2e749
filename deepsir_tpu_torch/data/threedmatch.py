"""3DMatch RGB-D fragment pairs (deepsir_tpu/data/threedmatch.py).

Train and val pairs come from the preprocessed pickles (points, and the
pairwise overlap ratios: pairs above OVERLAP_THRESH); test pairs from each
scene's gt.log trajectory and its cloud_bin_*.ply fragments, read by a
small PLY parser. Voxel 0.03 m. Augmentation: full random rotations about
random axes with recentring, small jitter and random scale in train.
"""
from __future__ import annotations

import os
import pickle
import struct
from typing import List

import numpy as np

from deepsir_tpu_torch.config import Config
from deepsir_tpu_torch.data.base import PairDataset
from deepsir_tpu_torch.data.transforms import fixed_resample
from deepsir_tpu_torch.math import rand, se3_np
from deepsir_tpu_torch.ops.voxel import voxel_downsample_np

TEST_SCENES = (
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
)

OVERLAP_THRESH = 0.3
VOXEL_SIZE = 0.03
_PLY_TYPES = {"float": "f", "float32": "f", "double": "d", "float64": "d", "uchar": "B",
              "uint8": "B", "char": "b", "int": "i", "uint": "I", "short": "h", "ushort": "H"}


def read_ply_xyz(path: str) -> np.ndarray:
    """The xyz of a PLY file's vertices (ascii or binary little endian),
    (N, 3) float32."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(h.split()[1] for h in header if h.startswith("format"))
        n_vertex = 0
        props: List[tuple] = []
        in_vertex = False
        for line in header:
            if line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list property in vertex element")
                props.append((parts[2], parts[1]))
        if fmt == "ascii":
            data = np.atleast_2d(np.loadtxt(f, max_rows=n_vertex, dtype=np.float64))
        elif fmt == "binary_little_endian":
            rec = "<" + "".join(_PLY_TYPES[t] for _, t in props)
            buf = f.read(struct.calcsize(rec) * n_vertex)
            data = np.array(list(struct.iter_unpack(rec, buf)), dtype=np.float64)
        else:
            raise ValueError(f"PLY format {fmt!r}")
    names = [n for n, _ in props]
    return data[:, [names.index("x"), names.index("y"), names.index("z")]].astype(np.float32)


def read_gt_log(path: str):
    """A gt.log trajectory: [(i, j, 4x4 pose), ...]."""
    out = []
    with open(path) as f:
        lines = f.readlines()
    k = 0
    while k < len(lines):
        meta = lines[k].split()
        if len(meta) < 2:
            break
        mat = np.array([[float(v) for v in lines[k + 1 + r].split()] for r in range(4)])
        out.append((int(meta[0]), int(meta[1]), mat))
        k += 5
    return out


class ThreeDMatch(PairDataset):
    def __init__(self, cfg: Config, split: str = "train"):
        super().__init__(cfg, split)
        if split not in ("train", "val", "test"):
            raise ValueError(f"split {split!r}")
        self.root_path = os.path.join(cfg.data.dataset_path, "3dmatch_train_val")
        self.test_path = os.path.join(cfg.data.dataset_path, "test")
        self.voxel_size = VOXEL_SIZE
        self.random_scale = split == "train"
        self.random_jitter = split == "train"
        self.random_rotation = split != "test"
        self.jitter.scale = 0.005
        self.files: list = []
        if split in ("train", "val"):
            self._load_train_index()
        else:
            self._load_test_index()
        if cfg.data.num_val > 0 and split == "val":
            self.files = self.files[:cfg.data.num_val]

    def _load_train_index(self):
        """The pairs of the split's overlap pickle above OVERLAP_THRESH, over
        the clouds of its points pickle (both written by
        scripts/preprocess_3dmatch.py)."""
        stem = os.path.join(self.root_path, f"3DMatch_{self.split}_0.030")
        with open(f"{stem}_points.pkl", "rb") as f:
            data = pickle.load(f)
        self.points = list(data.values())
        self.ids_list = list(data.keys())
        self.id_to_row = {k: i for i, k in enumerate(self.ids_list)}
        with open(f"{stem}_overlap.pkl", "rb") as f:
            overlaps = pickle.load(f)
        for pair_id, ratio in overlaps.items():
            if ratio > OVERLAP_THRESH:
                src_id, ref_id = pair_id.split("@")
                self.files.append((src_id, ref_id))

    def _load_test_index(self):
        for scene in TEST_SCENES:
            traj = read_gt_log(os.path.join(self.test_path, scene + "-evaluation", "gt.log"))
            for i, j, pose in traj:
                self.files.append((scene, i, j, pose))

    def __len__(self):
        return len(self.files)

    def augment_pair(self, rng, xyz0, xyz1, gt):
        """A random rotation of up to 90 degrees about a random axis of each
        cloud, recentred, instead of the LiDAR profile; then the exact-size
        resample, jitter and scale."""
        if self.random_rotation:
            t0 = rand.sample_random_trans(rng, xyz0, 90.0)
            t1 = rand.sample_random_trans(rng, xyz1, 90.0)
            xyz0 = se3_np.apply_to_cloud(t0, xyz0)
            xyz1 = se3_np.apply_to_cloud(t1, xyz1)
            gt = t1 @ gt @ np.linalg.inv(t0)
        if self.num_points > 0:
            xyz0 = fixed_resample(xyz0, self.num_points)
            xyz1 = fixed_resample(xyz1, self.num_points)
        if self.random_jitter:
            xyz0 = self.jitter.jitter(rng, xyz0)
            xyz1 = self.jitter.jitter(rng, xyz1)
        if self.random_scale:
            s = rng.uniform(self.min_scale, self.max_scale)
            xyz0 = xyz0.copy()
            xyz1 = xyz1.copy()
            xyz0[:, :3] *= s
            xyz1[:, :3] *= s
        return xyz0, xyz1, gt

    def get_pair(self, idx: int):
        rng = np.random.default_rng(idx)
        if self.split in ("train", "val"):
            src_id, ref_id = self.files[idx]
            src = self.points[self.id_to_row[src_id]].astype(np.float32)
            ref = self.points[self.id_to_row[ref_id]].astype(np.float32)
            gt = np.identity(4)
            meta = {"seq": src_id.split("/")[0], "id_src": int(src_id.split("_")[-1]),
                    "id_ref": int(ref_id.split("_")[-1])}
        else:
            scene, i, j, gt = self.files[idx]
            ref = read_ply_xyz(os.path.join(self.test_path, scene, f"cloud_bin_{i}.ply"))
            src = read_ply_xyz(os.path.join(self.test_path, scene, f"cloud_bin_{j}.ply"))
            meta = {"seq": scene, "id_src": j, "id_ref": i}
        src = voxel_downsample_np(src, self.voxel_size)
        ref = voxel_downsample_np(ref, self.voxel_size)
        src = src[rng.permutation(len(src))]
        ref = ref[rng.permutation(len(ref))]
        return src.astype(np.float32), ref.astype(np.float32), gt, meta
