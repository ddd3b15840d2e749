"""Oxford RobotCar pairs (deepsir_tpu/data/oxford.py).

A train sample crops one frame twice (60% half-space crops) into a
self-pair with the identity as ground truth; test pairs come from the
anchor/positive npy files with an xyz + quaternion pose. Crop r < 50 m, z
in (-3, 20); voxel 0.3 m. `oxford_pose_refine` refines the test poses by
ICP on 0.1 m-voxelized raw clouds, cached in `<root>/icp_refined_pose/`.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from deepsir_tpu_torch.config import Config
from deepsir_tpu_torch.data.base import PairDataset
from deepsir_tpu_torch.data.transforms import halfspace_crop, process_point_cloud
from deepsir_tpu_torch.math import se3_np
from deepsir_tpu_torch.ops.icp import icp_np
from deepsir_tpu_torch.ops.voxel import voxel_downsample_np

TRAIN_DIR = "train_np_nofilter"
TEST_DIR = "test_models_20k_np_nofilter"
P_CROP = 0.6
VOXEL_SIZE = 0.3


class Oxford(PairDataset):
    def __init__(self, cfg: Config, split: str = "train"):
        super().__init__(cfg, split)
        if split not in ("train", "val", "test"):
            raise ValueError(f"split {split!r}")
        self.root_path = cfg.data.dataset_path
        self.voxel_size = VOXEL_SIZE
        self.feat_len = 3
        self.random_scale = split == "train"
        self.jitter.scale = 0.05
        if split != "train":
            self.random_rotation = False
            self.random_jitter = False
            self.random_scale = False

        if split == "train":
            self.files = self._load_train_index()
        else:
            # the dataset's own index file, which this program does not write
            with open(os.path.join(self.root_path, TEST_DIR, "groundtruths.pkl"), "rb") as f:
                self.files = pickle.load(f)
        if cfg.data.num_val > 0 and split == "val":
            self.files = self.files[:cfg.data.num_val]

        self.pose_refine_enabled = cfg.data.oxford_pose_refine and split != "train"
        if self.pose_refine_enabled:
            self.icp_path = os.path.join(self.root_path, "icp_refined_pose")
            os.makedirs(self.icp_path, exist_ok=True)

    def pose_refine(self, xyz0: np.ndarray, xyz1: np.ndarray, t0, t1, m: np.ndarray,
                    voxel_size: float = 0.1) -> np.ndarray:
        """The catalogue pose `m` refined by ICP (max correspondence 0.2 m,
        200 iterations) on the raw clouds voxelized at `voxel_size`, cached
        per (positive, anchor) on disk."""
        cache_file = os.path.join(self.icp_path, f"{t0}_{t1}.npy")
        if os.path.exists(cache_file):
            return np.load(cache_file)
        sub0 = voxel_downsample_np(xyz0[:, :3], voxel_size)
        sub1 = voxel_downsample_np(xyz1[:, :3], voxel_size)
        refined = icp_np(sub0, sub1, max_corr_dist=0.2, init=m, max_iter=200)
        np.save(cache_file, refined)
        return refined

    def _load_train_index(self):
        """train_relative.txt: 'file | positives | non-negatives' per line."""
        out = []
        with open(os.path.join(self.root_path, TRAIN_DIR, "train_relative.txt")) as f:
            for line in f:
                parts = line.split("|")
                if len(parts) != 3:
                    continue
                out.append({"file": parts[0].strip(),
                            "pos_list": [int(v) for v in parts[1].split()],
                            "nonneg_list": [int(v) for v in parts[2].split()]})
        return out

    def __len__(self):
        return len(self.files)

    def get_pair(self, idx: int):
        rng = np.random.default_rng(idx)
        if self.split == "train":
            name = self.files[idx]["file"]
            cloud = np.load(os.path.join(self.root_path, TRAIN_DIR, name))[:, :3]
            xyz0 = halfspace_crop(rng, cloud, P_CROP)
            xyz1 = halfspace_crop(rng, cloud, P_CROP)
            gt = np.identity(4)
            meta = {"seq": None, "id_src": name, "id_ref": name}
        else:
            entry = self.files[idx]
            pos_idx, anc_idx = entry["pos_idx"], entry["anc_idx"]
            xyz0 = np.load(os.path.join(self.root_path, TEST_DIR, f"{pos_idx}.npy"))[:, :3]
            xyz1 = np.load(os.path.join(self.root_path, TEST_DIR, f"{anc_idx}.npy"))[:, :3]
            gt = se3_np.xyzquat2mat(np.concatenate([entry["t"], entry["q"]], axis=0))
            if self.pose_refine_enabled:
                gt = self.pose_refine(xyz0, xyz1, pos_idx, anc_idx, gt)
            meta = {"seq": None, "id_src": pos_idx, "id_ref": anc_idx}

        xyz0 = process_point_cloud(xyz0, r_min=0.0, r_max=50.0, z_min=-3.0, z_max=20.0)
        xyz1 = process_point_cloud(xyz1, r_min=0.0, r_max=50.0, z_min=-3.0, z_max=20.0)
        xyz0 = voxel_downsample_np(xyz0, self.voxel_size)
        xyz1 = voxel_downsample_np(xyz1, self.voxel_size)
        xyz0 = xyz0[rng.permutation(len(xyz0))]
        xyz1 = xyz1[rng.permutation(len(xyz1))]
        return xyz0.astype(np.float32), xyz1.astype(np.float32), gt, meta
