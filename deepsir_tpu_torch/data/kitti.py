"""KITTI odometry pairs, with SemanticKITTI labels (deepsir_tpu/data/kitti.py).

Train and val pairs are frames MIN_TIME_DIFF apart; test pairs follow the
3DFeatNet protocol (each pair's frames at least MIN_DIST metres apart, the
bad pair (8, 15, 58) removed). The ground-truth pose is the odometry pose
conjugated into the velodyne frame and refined by point-to-point ICP on
0.05-voxelized clouds, cached as `icp_opti_pose/<drive>_<t0>_<t1>.npy`. A
sample is radius/height cropped, permuted and voxel-downsampled, the label
column majority-voted per voxel.
"""
from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from deepsir_tpu_torch.config import Config
from deepsir_tpu_torch.data import semantic_kitti
from deepsir_tpu_torch.data.base import PairDataset
from deepsir_tpu_torch.data.transforms import process_point_cloud
from deepsir_tpu_torch.ops.icp import icp_np
from deepsir_tpu_torch.ops.voxel import voxel_downsample_np

TRAIN_SEQS = (0, 1, 2, 3, 4, 5)
VAL_SEQS = (6, 7)
TEST_SEQS = (8, 9, 10)

MIN_TIME_DIFF = 2
MAX_TIME_DIFF = 3
MIN_DIST = 10.0          # metres between a test pair's poses
BAD_TEST_PAIRS = {(8, 15, 58)}

# velodyne -> cam0 calibration of the odometry benchmark (public KITTI calib)
_VELO2CAM_R = np.array([
    [7.533745e-03, -9.999714e-01, -6.166020e-04],
    [1.480249e-02, 7.280733e-04, -9.998902e-01],
    [9.998621e-01, 7.523790e-03, 1.480755e-02]])
_VELO2CAM_T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01])


def velo2cam_4x4() -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = _VELO2CAM_R
    out[:3, 3] = _VELO2CAM_T
    return out


class KITTIPair(PairDataset):
    has_labels = False

    def __init__(self, cfg: Config, split: str = "train"):
        super().__init__(cfg, split)
        if split not in ("train", "val", "test"):
            raise ValueError(f"split {split!r}")
        self.voxel_size = cfg.data.voxel_size
        self.root_path = os.path.join(cfg.data.dataset_path, "dataset")
        self.icp_path = os.path.join(cfg.data.dataset_path, "icp_opti_pose")
        os.makedirs(self.icp_path, exist_ok=True)
        self.permutation = split != "test"
        if split != "train":
            self.random_rotation = False
            self.random_jitter = False
            self.random_scale = False

        self._pose_cache: dict = {}
        self.files: List[Tuple[int, int, int]] = []
        seqs = self._split_seqs(split)
        if split == "test":
            self._prepare_distance_pairs(seqs)
        else:
            self._prepare_time_pairs(seqs)
        if cfg.data.num_val > 0 and split == "val":
            self.files = self.files[:cfg.data.num_val]

    def _split_seqs(self, split: str) -> Tuple[int, ...]:
        """The split's sequence ids: `<dataset_path>/split/<split>_kitti.txt`
        where it exists, else the published defaults."""
        path = os.path.join(self.cfg.data.dataset_path, "split", f"{split}_kitti.txt")
        if os.path.exists(path):
            with open(path) as f:
                return tuple(int(v) for v in f.read().split())
        return {"train": TRAIN_SEQS, "val": VAL_SEQS, "test": TEST_SEQS}[split]

    def _scan_ids(self, drive: int) -> List[int]:
        pattern = os.path.join(self.root_path, "sequences", f"{drive:02d}", "velodyne", "*.bin")
        names = glob.glob(pattern)
        if not names:
            raise FileNotFoundError(f"no velodyne scans under {pattern}")
        return sorted(int(os.path.basename(f)[:-4]) for f in names)

    def _prepare_time_pairs(self, seqs) -> None:
        """Train and val pairs: frames MIN..MAX-1 apart (with the defaults,
        exactly 2; drive 1's shorter cap is never reached at them)."""
        for drive in seqs:
            ids = set(self._scan_ids(drive))
            max_diff = MAX_TIME_DIFF - 1 if (drive == 1 and MAX_TIME_DIFF - 1 > MIN_TIME_DIFF) \
                else MAX_TIME_DIFF
            for t0 in sorted(ids):
                for diff in range(MIN_TIME_DIFF, max_diff):
                    if t0 + diff in ids:
                        self.files.append((drive, t0, t0 + diff))

    def _prepare_distance_pairs(self, seqs) -> None:
        """Test pairs: successive frames at least MIN_DIST apart."""
        for drive in seqs:
            ids = self._scan_ids(drive)
            id_set = set(ids)
            translations = np.stack([self._odometry_pose(drive, t) for t in ids])[:, :3, 3]
            t_by_id = {t: i for i, t in enumerate(ids)}
            curr = ids[0]
            while curr in id_set:
                row = t_by_id[curr]
                ahead = translations[row:row + 100]
                far = np.where(np.sum((ahead - translations[row]) ** 2, axis=-1)
                               > MIN_DIST ** 2)[0]
                if len(far) == 0:
                    curr += 1
                    continue
                nxt = curr + int(far[0]) - 1
                if nxt in id_set:
                    if (drive, curr, nxt) not in BAD_TEST_PAIRS:
                        self.files.append((drive, curr, nxt))
                    curr = nxt + 1
                else:
                    curr += 1

    def __len__(self) -> int:
        return len(self.files)

    def _velodyne_path(self, drive: int, t: int) -> str:
        return os.path.join(self.root_path, "sequences", f"{drive:02d}", "velodyne",
                            f"{t:06d}.bin")

    def _odometry_pose(self, drive: int, t: int) -> np.ndarray:
        path = os.path.join(self.root_path, "poses", f"{drive:02d}.txt")
        if path not in self._pose_cache:
            self._pose_cache[path] = np.genfromtxt(path)
        return np.vstack([self._pose_cache[path][t].reshape(3, 4), [0, 0, 0, 1]])

    def load_labels(self, drive: int, t: int, n: int) -> np.ndarray:
        return np.zeros(n, dtype=np.uint8)

    def refined_pose(self, drive: int, t0: int, t1: int, xyz0: np.ndarray,
                     xyz1: np.ndarray, icp_voxel: float = 0.05) -> np.ndarray:
        """The odometry pose conjugated into the velodyne frame, refined by
        ICP and cached on disk (a cache written by the JAX package is read)."""
        cache_file = os.path.join(self.icp_path, f"{drive}_{t0}_{t1}.npy")
        if os.path.exists(cache_file):
            return np.load(cache_file)
        p0 = self._odometry_pose(drive, t0)
        p1 = self._odometry_pose(drive, t1)
        v2c_t = velo2cam_4x4().T
        m = (v2c_t @ p0.T @ np.linalg.inv(p1.T) @ np.linalg.inv(v2c_t)).T
        sub0 = voxel_downsample_np(xyz0[:, :3], icp_voxel)
        sub1 = voxel_downsample_np(xyz1[:, :3], icp_voxel)
        refined = icp_np(sub0, sub1, max_corr_dist=0.2, init=m, max_iter=200)
        np.save(cache_file, refined)
        return refined

    def get_pair(self, idx: int):
        drive, t0, t1 = self.files[idx]
        raw0 = np.fromfile(self._velodyne_path(drive, t0), dtype=np.float32).reshape(-1, 4)
        raw1 = np.fromfile(self._velodyne_path(drive, t1), dtype=np.float32).reshape(-1, 4)
        # columns: x y z reflectance label
        cloud0 = np.concatenate([raw0, self.load_labels(drive, t0, len(raw0))[:, None]], axis=1)
        cloud1 = np.concatenate([raw1, self.load_labels(drive, t1, len(raw1))[:, None]], axis=1)
        cloud0 = process_point_cloud(cloud0, r_min=3.0, r_max=60.0, z_min=-3.0, z_max=10.0)
        cloud1 = process_point_cloud(cloud1, r_min=3.0, r_max=60.0, z_min=-3.0, z_max=10.0)

        rng = np.random.default_rng((drive, t0, t1))
        if self.permutation:
            cloud0 = cloud0[rng.permutation(len(cloud0))]
            cloud1 = cloud1[rng.permutation(len(cloud1))]
        gt = self.refined_pose(drive, t0, t1, cloud0, cloud1)

        # reflectance averaged per voxel, the label majority-voted
        sub0 = voxel_downsample_np(cloud0, self.voxel_size, label_column=4)
        sub1 = voxel_downsample_np(cloud1, self.voxel_size, label_column=4)
        # shuffled after the deterministic voxel pass: the pyramid samples
        # the first rows of each level
        sub0 = sub0[rng.permutation(len(sub0))]
        sub1 = sub1[rng.permutation(len(sub1))]
        meta = {"seq": drive, "id_src": t0, "id_ref": t1}
        return sub0.astype(np.float32), sub1.astype(np.float32), gt, meta


class SemanticKITTIPair(KITTIPair):
    """KITTI pairs with SemanticKITTI per-point labels."""
    has_labels = True
    label_column = 4

    def load_labels(self, drive: int, t: int, n: int) -> np.ndarray:
        if drive > 10:   # no labels are published beyond sequence 10
            return np.zeros(n, dtype=np.uint8)
        path = os.path.join(self.root_path, "sequences", f"{drive:02d}", "labels",
                            f"{t:06d}.label")
        return semantic_kitti.read_label_file(path)
