"""The dataset of a config's `dataset_type` and split
(deepsir_tpu/data/datasets.py)."""
from __future__ import annotations

from typing import Tuple

from deepsir_tpu_torch.config import Config
from deepsir_tpu_torch.data.base import PairDataset


def _build(cfg: Config, split: str) -> PairDataset:
    ds = cfg.data.dataset_type
    if ds == "KITTI":
        from deepsir_tpu_torch.data.kitti import SemanticKITTIPair
        return SemanticKITTIPair(cfg, split)
    if ds == "3DMatch":
        from deepsir_tpu_torch.data.threedmatch import ThreeDMatch
        return ThreeDMatch(cfg, split)
    if ds == "Oxford":
        from deepsir_tpu_torch.data.oxford import Oxford
        return Oxford(cfg, split)
    if ds == "Synthetic":
        from deepsir_tpu_torch.data.synthetic import SyntheticPairs
        size = {"train": cfg.data.synthetic_train_size,
                "test": cfg.data.synthetic_eval_size}.get(split)
        return SyntheticPairs(cfg, split, size=size, noise=cfg.data.synthetic_noise,
                              p_keep=cfg.data.synthetic_p_keep,
                              offset=cfg.data.synthetic_eval_offset if split == "test" else 0)
    raise NotImplementedError(ds)


def get_train_datasets(cfg: Config) -> Tuple[PairDataset, PairDataset]:
    """(train, val) datasets."""
    return _build(cfg, "train"), _build(cfg, "val")


def get_test_dataset(cfg: Config) -> PairDataset:
    return _build(cfg, "test")
