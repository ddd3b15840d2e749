"""Model configuration for the port.

A copy of the `ModelConfig` fields of deepsir_tpu/config.py:32-181 that the
align inference forward reads, with the same names and defaults. The port
implements one slice of that configuration space (`check_supported`); any
other value of an option raises `NotImplementedError` naming the option
instead of silently taking another path. `from_run_config` reads the
`config.json` a training run writes beside its checkpoints.

Precision: the port computes at fp32 grade whatever the precision fields
say: fp32 torch matmuls with TF32 off (deepsir_tpu_torch/__init__.py), and
the match kernels K2/K3 in 3xTF32. That is what the JAX package computes on
the CPU for every value of `inlier_matmul_precision` and
`matcher_matmul_precision`; the two fields are kept so that a run's config
maps one for one. `matmul_precision` other than "highest" raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Tuple, Union


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
    matmul_precision: str = "highest"
    inlier_matmul_precision: str = "default"
    matcher_matmul_precision: str = "default"
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
    "compute_dtype": "float32",
    "inlier_compute_dtype": "float32",
    "matmul_precision": "highest",
}

# keys of a run's "model" block that cannot change the align inference
# forward, with the reason; `from_run_config` drops them
IGNORED_KEYS = {
    "num_sub": "only forward_pair reads it (deepsir_tpu/models/network.py:272), "
               "not the align forward",
    "dropout_rate": "dropout acts in training only (deepsir_tpu/models/randla.py:185)",
    "knn_recall_target": "the port's KNN is exact, and so is JAX's on the CPU "
                         "(deepsir_tpu/config.py:61)",
    "matcher_method": "it picks Pallas or XLA for the same function "
                      "(deepsir_tpu/ops/distance.py:106)",
    "num_train_reg_iter": "training only (deepsir_tpu/training.py:87)",
    "no_slack": "nothing in deepsir_tpu/ reads it outside config.py",
    "num_sk_iter": "nothing in deepsir_tpu/ reads it outside config.py",
}


def inlier_extras(cfg: ModelConfig) -> Tuple[str, ...]:
    """The names in cfg.inlier_extra_feats, in the order of the string."""
    return tuple(s.strip() for s in cfg.inlier_extra_feats.split(",") if s.strip())


def _unported(name: str, value, ported: str) -> NotImplementedError:
    return NotImplementedError(f"ModelConfig.{name}={value!r} is not ported "
                               f"(the port implements {ported})")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the first option outside the slice.

    Besides the defaults the port implements:
    - `inlier_extra_feats` made of "dist" and "recip" (each at most once,
      any order), `mutual_check` with any `mutual_check_tol >= 0`;
    - `pyramid_order="morton"` with `knn_window_halo >= 1`;
    - `inlier_num_layers` L with 0 <= L < len(d_out), `inlier_num_knn` and
      `backbone_num_knn` >= 0, `refine_stride` >= 1, `absolute_pose_solve`;
    - `fc_norm` "group" or "none", `randla_skips` "pre" or "post".
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
    if not 0 <= cfg.inlier_num_layers < len(cfg.d_out):
        raise _unported("inlier_num_layers", cfg.inlier_num_layers,
                        f"0 <= inlier_num_layers < {len(cfg.d_out)}")
    for name in ("inlier_num_knn", "backbone_num_knn"):
        if getattr(cfg, name) < 0:
            raise _unported(name, getattr(cfg, name), f"{name} >= 0")
    if cfg.refine_stride < 1:
        raise _unported("refine_stride", cfg.refine_stride, "refine_stride >= 1")
    if cfg.fc_norm not in ("group", "none"):
        raise _unported("fc_norm", cfg.fc_norm, "'group' and 'none'")
    if cfg.randla_skips not in ("pre", "post"):
        raise _unported("randla_skips", cfg.randla_skips, "'pre' and 'post'")
    if len(cfg.sub_sampling_ratio) != len(cfg.d_out):
        raise ValueError("sub_sampling_ratio and d_out differ in length")


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def _config_from_fields(fields: Mapping) -> ModelConfig:
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in fields.items()})


def from_json(text: str) -> ModelConfig:
    """ModelConfig from a JSON object of its fields (lists become tuples)."""
    return _config_from_fields(json.loads(text))


def from_run_config(run: Union[str, os.PathLike, Mapping]) -> ModelConfig:
    """The align ModelConfig of a training run's `config.json`.

    `run` is the parsed JSON object, the file, or the run directory holding
    it. The fields of its "model" block map one for one; a field it lacks
    (older runs lack some) takes the default. A key of `IGNORED_KEYS` is
    dropped; any other unknown key raises ValueError naming it, as does a
    run of another pipeline. The result passes `check_supported`.
    """
    if not isinstance(run, Mapping):
        path = Path(run)
        run = json.loads((path / "config.json" if path.is_dir() else path).read_text())
    if run.get("pipeline") != "align":
        raise ValueError(f"run config of pipeline {run.get('pipeline')!r}; "
                         f"only 'align' is ported")
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    model = run["model"]
    unknown = sorted(set(model) - known - set(IGNORED_KEYS))
    if unknown:
        raise ValueError(f"run config model keys {unknown} are not known to the port")
    cfg = _config_from_fields({k: v for k, v in model.items() if k in known})
    check_supported(cfg)
    return cfg
