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
    knn_window_halo: int = 1          # window blocks per side (morton only)
    num_reg_iter: int = 5
    clip_weight_thresh: float = 0.0
    absolute_pose_solve: bool = False
    mutual_check: bool = False
    mutual_check_tol: float = 0.0     # gate radius; 0 = exact reciprocity


INLIER_EXTRAS = ("dist", "recip")

# the one value of each option that the port implements; the options checked
# by `check_supported` itself admit more
_SLICE = {
    "use_ppf": False,
    "fc_norm": "group",
    "randla_skips": "pre",
    "compute_dtype": "float32",
    "inlier_compute_dtype": "float32",
    "inlier_num_layers": 0,
    "inlier_num_knn": 0,
    "backbone_num_knn": 0,
    "refine_stride": 1,
    "absolute_pose_solve": False,
}


def inlier_extras(cfg: ModelConfig) -> Tuple[str, ...]:
    """The names in cfg.inlier_extra_feats, in the order of the string."""
    return tuple(s.strip() for s in cfg.inlier_extra_feats.split(",") if s.strip())


def _unported(name: str, value, ported: str) -> NotImplementedError:
    return NotImplementedError(f"ModelConfig.{name}={value!r} is not ported "
                               f"(the port implements {ported})")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the first option outside the slice.

    Besides the defaults the port implements `inlier_extra_feats` made of
    "dist" and "recip" (each at most once, any order), `mutual_check` with
    any `mutual_check_tol >= 0`, and `pyramid_order="morton"` with
    `knn_window_halo >= 1`.
    """
    for name, value in _SLICE.items():
        if getattr(cfg, name) != value:
            raise _unported(name, getattr(cfg, name), f"{name}={value!r}")
    extras = inlier_extras(cfg)
    if not set(extras) <= set(INLIER_EXTRAS) or len(set(extras)) != len(extras):
        raise _unported("inlier_extra_feats", cfg.inlier_extra_feats,
                        "each of 'dist' and 'recip' at most once")
    if cfg.mutual_check_tol < 0:
        raise _unported("mutual_check_tol", cfg.mutual_check_tol, "tolerances >= 0")
    if cfg.pyramid_order not in ("shuffled", "morton"):
        raise _unported("pyramid_order", cfg.pyramid_order, "'shuffled' and 'morton'")
    if cfg.pyramid_order == "morton" and cfg.knn_window_halo < 1:
        raise _unported("knn_window_halo", cfg.knn_window_halo,
                        "knn_window_halo >= 1 under pyramid_order='morton'")
    if len(cfg.sub_sampling_ratio) != len(cfg.d_out):
        raise ValueError("sub_sampling_ratio and d_out differ in length")


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def from_json(text: str) -> ModelConfig:
    """ModelConfig from a JSON object of its fields (lists become tuples)."""
    fields = json.loads(text)
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in fields.items()})
