"""The data layer's core (deepsir_tpu/data/base.py): pair augmentation,
samples of one static shape, and the threaded batch loader.

A dataset reads raw cloud pairs (`get_pair`), augments them, resamples each
cloud to exactly `num_points` rows and, under `pyramid_order="morton"`,
curve-sorts it (`get_sample`). Val and test samples carry validity masks
over the rows of the raw cloud, align train and val samples under
`gt_match_lists` a padded ground-truth match list. `Loader` batches the
samples of an epoch with a thread pool; every sample draws from its own
np.random.Generator seeded from (seed, epoch, index), so a batch depends
on neither the worker count nor the scheduling, and the port's batches are
the JAX package's bit for bit. The pyramid is built on the device
(training.device_batch), not here.
"""
from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from deepsir_tpu_torch.config import Config
from deepsir_tpu_torch.data import transforms as T
from deepsir_tpu_torch.ops.morton import morton_order_np
from deepsir_tpu_torch.ops.radius_match import pad_matches, radius_matches_np

_logger = logging.getLogger(__name__)


class PairDataset:
    """Base class of the pair datasets (KITTI, 3DMatch, Oxford, Synthetic).

    Subclasses implement __len__ and get_pair(idx) -> (cloud0 (N0, C),
    cloud1 (N1, C), gt 4x4, meta dict). Columns: xyz, then extra feature
    channels, then (optionally) an integer label column last.
    """

    # augmentation switches; subclasses override them per split
    random_rotation = True
    random_jitter = True
    random_scale = False
    min_scale, max_scale = 0.8, 1.2
    has_labels = False
    label_column: Optional[int] = None

    def __init__(self, cfg: Config, split: str):
        self.cfg = cfg
        self.split = split
        self.num_points = cfg.model.num_points
        self.feat_len = cfg.model.feat_len
        self.pipeline = cfg.pipeline
        self.thres_radius = cfg.data.thres_radius
        self.max_matches = cfg.data.max_matches
        self.rot_z = T.RandomRotatorZ(60.0)
        self.perturb = T.RandomTransformSE3Euler(
            cfg.data.rot_mag, cfg.data.trans_mag, cfg.data.xy_rot_scale)
        self.jitter = T.RandomJitter(scale=0.01, clip=0.05)
        self._cache: Dict[int, tuple] = {}
        self._cache_lock = threading.Lock()
        self.cache_size = 500
        self._truncated = 0             # samples whose GT match list was cut
        self._truncated_frac = 0.0

    def __len__(self) -> int:
        raise NotImplementedError

    def get_pair(self, idx: int):
        raise NotImplementedError

    def _cached_pair(self, idx: int):
        with self._cache_lock:
            if idx in self._cache:
                return self._cache[idx]
        pair = self.get_pair(idx)
        with self._cache_lock:
            if len(self._cache) < self.cache_size:
                self._cache[idx] = pair
        return pair

    def augment_pair(self, rng: np.random.Generator, xyz0: np.ndarray,
                     xyz1: np.ndarray, gt: np.ndarray):
        """Random z rotations of both clouds and an SE(3) perturbation of the
        source, with the ground truth composed to match; then the exact-size
        resample and jitter.

        new_src = T_perturb T0 src ; new_ref = T1 ref ; ref = gt src
        => new gt = T1 gt inv(T0) inv(T_perturb)
        """
        if self.random_rotation:
            xyz0, _, t0 = self.rot_z.transform(rng, xyz0)
            xyz1, _, t1 = self.rot_z.transform(rng, xyz1)
            xyz0, _, t00 = self.perturb.transform(rng, xyz0)
            gt = t1 @ gt @ np.linalg.inv(t0) @ np.linalg.inv(t00)

        if self.num_points > 0:
            if self.split == "train":
                # a fresh permutation per epoch before the deterministic
                # resample: the cached pair's order is frozen, and without
                # it every epoch would see the same subset and pyramid
                xyz0 = xyz0[rng.permutation(len(xyz0))]
                xyz1 = xyz1[rng.permutation(len(xyz1))]
            xyz0 = T.fixed_resample(xyz0, self.num_points)
            xyz1 = T.fixed_resample(xyz1, self.num_points)

        if self.random_jitter:
            xyz0 = self.jitter.jitter(rng, xyz0)
            xyz1 = self.jitter.jitter(rng, xyz1)

        if self.random_scale:
            scale = rng.uniform(self.min_scale, self.max_scale)
            xyz0 = xyz0.copy()
            xyz1 = xyz1.copy()
            xyz0[:, :3] *= scale
            xyz1[:, :3] *= scale
        return xyz0, xyz1, gt

    def _curve_sort(self, cloud: np.ndarray, n_raw: int) -> np.ndarray:
        """The cloud with its valid prefix in Morton order (train samples have
        no padding: all of it). Rebinds: `fixed_resample` may return a view
        of the cached raw pair, which must stay as read."""
        nv = len(cloud) if self.split == "train" else min(n_raw, len(cloud))
        head = cloud[:nv][morton_order_np(cloud[:nv, :3])]
        return head if nv == len(cloud) else np.concatenate([head, cloud[nv:]], axis=0)

    def get_sample(self, idx: int, rng: np.random.Generator) -> Dict:
        """One augmented sample of the static shape."""
        cloud0, cloud1, gt, meta = self._cached_pair(idx)
        n0_raw, n1_raw = len(cloud0), len(cloud1)
        cloud0, cloud1, gt = self.augment_pair(rng, cloud0, cloud1, gt)
        if self.cfg.model.pyramid_order == "morton":
            cloud0 = self._curve_sort(cloud0, n0_raw)
            cloud1 = self._curve_sort(cloud1, n1_raw)

        sample: Dict = {
            "points_src": cloud0[:, :self.feat_len].astype(np.float32),
            "points_ref": cloud1[:, :self.feat_len].astype(np.float32),
            "transform_gt": gt[:3, :].astype(np.float32),
            "meta": meta,
        }
        if self.split != "train" and self.num_points > 0:
            # val and test clouds are padded by tiling their raw rows: the
            # masks mark the raw prefix, so that matching, the pose solve,
            # the loss and the metrics see the natural cloud
            n = self.num_points
            sample["mask_src"] = (np.arange(n) < min(n0_raw, n)).astype(np.float32)
            sample["mask_ref"] = (np.arange(n) < min(n1_raw, n)).astype(np.float32)
        if self.has_labels and self.label_column is not None:
            sample["labels_src"] = cloud0[:, self.label_column].astype(np.int32)
            sample["labels_ref"] = cloud1[:, self.label_column].astype(np.int32)

        if (self.pipeline == "align" and self.split in ("train", "val")
                and self.cfg.data.gt_match_lists):
            matches = radius_matches_np(cloud0[:, :3], cloud1[:, :3], gt, self.thres_radius)
            padded, num = pad_matches(matches, self.max_matches)
            if len(matches) > self.max_matches:
                # a cut list labels correct matches past the cap as wrong
                self._truncated += 1
                self._truncated_frac = max(self._truncated_frac,
                                           1.0 - self.max_matches / len(matches))
                if self._truncated in (1, 100, 10000):
                    _logger.warning(
                        "GT match list truncated on %d sample(s) so far (worst loss: "
                        "%.1f%% of matches dropped); raise data.max_matches (%d) to "
                        "avoid BCE mislabeling", self._truncated,
                        100 * self._truncated_frac, self.max_matches)
            sample["matches"] = padded
            sample["num_matches"] = num
        return sample


def make_pair_arrays(samples: List[Dict]) -> Dict[str, np.ndarray]:
    """Stack sample dicts into one batch of numpy arrays, and the metas as a
    list."""
    batch: Dict = {k: np.stack([s[k] for s in samples])
                   for k in ("points_src", "points_ref", "transform_gt")}
    for pair in (("labels_src", "labels_ref"), ("mask_src", "mask_ref"), ("matches",)):
        if pair[0] in samples[0]:
            batch.update({k: np.stack([s[k] for s in samples]) for k in pair})
    if "matches" in samples[0]:
        batch["num_matches"] = np.asarray([s["num_matches"] for s in samples], dtype=np.int32)
    batch["meta"] = [s["meta"] for s in samples]
    return batch


class Loader:
    """Batches of a dataset in shuffled or index order, made by a thread pool
    a bounded window ahead of the consumer.

    A shuffled loader draws epoch e's order from default_rng(seed + e) and
    sample i's generator from default_rng((seed, e + 1, i)); an unshuffled
    one (val, test) from default_rng((seed, 0, i)) in every sweep, so that
    each sweep sees the same samples.
    """

    def __init__(self, dataset: PairDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, num_workers: int = 4, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        # the epoch is bound here, so that work in flight keeps its stream
        # when the iterator is abandoned or a second one opens
        epoch = self.epoch = self.epoch + 1

        def fetch(i):
            rng = np.random.default_rng((self.seed, epoch if self.shuffle else 0, int(i)))
            return self.dataset.get_sample(int(i), rng)

        stop = n - n % self.batch_size if self.drop_last else n
        # a sliding window of a few batches: memory stays O(window), not
        # O(epoch)
        window = self.batch_size * max(2, 2 * self.num_workers)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = {}
            submitted = 0
            for start in range(0, stop, self.batch_size):
                end = min(start + self.batch_size, n)
                while submitted < min(end + window, n):
                    futures[submitted] = pool.submit(fetch, order[submitted])
                    submitted += 1
                yield make_pair_arrays([futures.pop(i).result() for i in range(start, end)])
