"""Model configuration for the port.

A copy of the `ModelConfig` fields of deepsir_tpu/config.py:32-181 that the
align inference forward reads, with the same names and defaults. The port
implements one slice of that configuration space (`check_supported`); any
other value of an option raises `NotImplementedError` naming the option
instead of silently taking another path.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Network architecture settings (deepsir_tpu/config.py:ModelConfig)."""
    feat_len: int = 4                 # 3 (xyz) or 4 (xyz+reflectance)
    use_ppf: bool = False
    num_points: int = 18000           # points per cloud
    num_knn: int = 16                 # neighbours in the KNN graph
    sub_sampling_ratio: Tuple[int, ...] = (4, 4, 4, 4)
    d_out: Tuple[int, ...] = (16, 64, 128, 256)   # encoder dims per layer
    out_feat_dim: int = 64            # descriptor dimension
    num_classes: int = 19             # SemanticKITTI valid classes
    fc_norm: str = "group"            # 'group' | 'batch' | 'none'
    randla_skips: str = "pre"         # 'pre' | 'post'
    compute_dtype: str = "float32"
    inlier_compute_dtype: str = "float32"
    inlier_num_layers: int = 0
    inlier_num_knn: int = 0
    backbone_num_knn: int = 0
    inlier_extra_feats: str = ""
    refine_stride: int = 1
    pyramid_order: str = "shuffled"   # 'shuffled' | 'morton'
    num_reg_iter: int = 5
    clip_weight_thresh: float = 0.0
    absolute_pose_solve: bool = False
    mutual_check: bool = False


# the one value of each option that the port implements
_SLICE = {
    "use_ppf": False,
    "fc_norm": "group",
    "randla_skips": "pre",
    "compute_dtype": "float32",
    "inlier_compute_dtype": "float32",
    "inlier_num_layers": 0,
    "inlier_num_knn": 0,
    "backbone_num_knn": 0,
    "inlier_extra_feats": "",
    "refine_stride": 1,
    "pyramid_order": "shuffled",
    "absolute_pose_solve": False,
    "mutual_check": False,
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the first option outside the slice."""
    for name, value in _SLICE.items():
        if getattr(cfg, name) != value:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(cfg, name)!r} is not ported "
                f"(the port implements {name}={value!r})")
    if len(cfg.sub_sampling_ratio) != len(cfg.d_out):
        raise ValueError("sub_sampling_ratio and d_out differ in length")


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def from_json(text: str) -> ModelConfig:
    """ModelConfig from a JSON object of its fields (lists become tuples)."""
    fields = json.loads(text)
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in fields.items()})
