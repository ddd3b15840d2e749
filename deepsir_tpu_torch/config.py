"""Model, loss and training configuration for the port.

A copy of the `ModelConfig` fields of deepsir_tpu/config.py:32-181 that the
three pipelines (label, feat, align) and their training steps read, of
`LossConfig`, of the `TrainConfig` fields the training step reads and of
`EvalConfig`, with the same names and defaults. The port implements one
slice of the model configuration space (`check_supported`); any other value
of an option raises `NotImplementedError` naming the option instead of
silently taking another path. `from_run_config` reads the model block of the `config.json` a
training run writes beside its checkpoints, `read_run_config` its pipeline,
its model, loss, training and eval blocks and the data block's voxel size.

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
from typing import Mapping, NamedTuple, Optional, Tuple, Union


@dataclass(frozen=True)
class ModelConfig:
    """Network architecture settings (deepsir_tpu/config.py:ModelConfig)."""
    feat_len: int = 4                 # 3 (xyz) or 4 (xyz+reflectance)
    use_ppf: bool = False
    num_points: int = 18000           # points per cloud
    num_sub: int = -1                 # feat: top-k scored points kept (<= 0: all)
    num_knn: int = 16                 # neighbours in the KNN graph
    sub_sampling_ratio: Tuple[int, ...] = (4, 4, 4, 4)
    d_out: Tuple[int, ...] = (16, 64, 128, 256)   # encoder dims per layer
    out_feat_dim: int = 64            # descriptor dimension
    num_classes: int = 19             # SemanticKITTI valid classes
    dropout_rate: float = 0.5         # before fc_label, in training only
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
    num_train_reg_iter: int = 2       # registration iterations of a training step
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

PIPELINES = ("label", "feat", "align")

# keys of a run's "model" block that cannot change a forward or a training
# step, with the reason; `from_run_config` drops them
IGNORED_KEYS = {
    "knn_recall_target": "the port's KNN is exact, and so is JAX's on the CPU "
                         "(deepsir_tpu/config.py:61)",
    "matcher_method": "it picks Pallas or XLA for the same function "
                      "(deepsir_tpu/ops/distance.py:106)",
    "no_slack": "nothing in deepsir_tpu/ reads it outside config.py",
    "num_sk_iter": "nothing in deepsir_tpu/ reads it outside config.py",
}


@dataclass(frozen=True)
class LossConfig:
    """Loss weights (deepsir_tpu/config.py:LossConfig). The align loss reads
    loss_type, the three wt_* weights, loss_discount_factor and thres_radius;
    the feat loss thres_radius, det_loss_weight, circle_loss_tile and
    overlap_det_mask."""
    loss_type: str = "mae"            # 'mae' | 'mse'
    wt_ptDist_loss: float = 1.0
    wt_inlier_loss: float = 1.0
    wt_pose_loss: float = 0.0
    loss_discount_factor: float = 0.5
    det_loss_weight: float = 1.0
    chamfer_loss_weight: float = 0.0
    feat_loss_weight: float = 0.0
    thres_radius: float = -1.0        # <= 0: voxel_size * positive_pair_radius_multiplier
    circle_loss_tile: int = 0
    overlap_det_mask: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """The fields of deepsir_tpu/config.py:TrainConfig that the training
    step reads: the learning-rate schedule, the batch size and the seed."""
    lr: float = 1e-3
    lr_decay_epoch: int = 4
    lr_decay_ratio: float = 0.98
    lr_clip: float = 1e-4
    batch_size: int = 1
    seed: int = 0


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation settings (deepsir_tpu/config.py:EvalConfig). The stored run
    configs are resolved: their thresholds are the dataset's already."""
    transform_file: Optional[str] = None
    eval_save_path: str = "./out/"
    batch_size: int = 1
    rte_thresh: float = 0.6           # success thresholds
    rre_thresh: float = 5.0
    # the refiners of evaluation.pose_optimization, all off by default
    use_finetune: bool = False
    use_icp: bool = False
    use_ransac: bool = False
    # dtype of the point payloads on their way to the device ("float16"
    # halves the bytes; device_batch upcasts to fp32 before any math)
    transfer_dtype: str = "float32"
    # chordal mean of the last k iterations' poses as the final pose (0/1 off)
    pose_average_last: int = 0


class RunConfig(NamedTuple):
    """What the training step and the eval harness read of a run's config.json."""
    model: ModelConfig
    loss: LossConfig
    train: TrainConfig
    pipeline: str = "align"           # one of PIPELINES
    eval: EvalConfig = EvalConfig()
    # the data block's voxel size: the refiners' correspondence distance is
    # twice it (deepsir_tpu/evaluation.py:134)
    voxel_size: float = 0.3


# keys of a run's "data" and "train" blocks that the training step does not
# read, with the reason; `read_run_config` drops them
DATA_READ = ("voxel_size", "positive_pair_radius_multiplier")
IGNORED_DATA_KEYS = {
    "dataset_path": "the data layer is not ported",
    "dataset_type": "it picks the data layer's reader; the stored config is "
                    "the resolved one, whose voxel_size is already the dataset's",
    "rot_mag": "an augmentation of the data layer (not ported)",
    "xy_rot_scale": "an augmentation of the data layer (not ported)",
    "trans_mag": "an augmentation of the data layer (not ported)",
    "num_val": "the validation subset of train.py (not ported)",
    "num_workers": "host loader workers (not ported)",
    "max_matches": "the capacity of the data layer's match lists; the step "
                   "reads the lists' shape",
    "gt_match_lists": "the data layer ships `matches` only under it; the step "
                      "takes the list BCE exactly when the batch has them",
    "oxford_pose_refine": "a reader option of the data layer (not ported)",
    "synthetic_train_size": "the synthetic split's size; the caller passes "
                            "steps_per_epoch",
    "synthetic_eval_size": "the synthetic eval split (not ported)",
    "synthetic_noise": "the synthetic generator (not ported)",
    "synthetic_p_keep": "the synthetic generator (not ported)",
    "synthetic_eval_offset": "the synthetic eval split (not ported)",
}
IGNORED_TRAIN_KEYS = {
    "summary_every": "logging cadence of train.py (not ported)",
    "validate_every": "validation cadence of train.py (not ported)",
    "rte_thresh": "the validation's success threshold (not ported)",
    "rre_thresh": "the validation's success threshold (not ported)",
    "resume": "train.py's checkpoint path; the caller loads it with "
              "utils.checkpoint.load_train_state",
    "load_model_all": "train.py's restore mode (not ported)",
    "max_epochs": "train.py's loop length (not ported)",
    "data_parallel": "the multi-device paths (not ported)",
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
    - `fc_norm` "group", "batch" or "none", `randla_skips` "pre" or "post".
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
    if cfg.fc_norm not in ("group", "batch", "none"):
        raise _unported("fc_norm", cfg.fc_norm, "'group', 'batch' and 'none'")
    if cfg.randla_skips not in ("pre", "post"):
        raise _unported("randla_skips", cfg.randla_skips, "'pre' and 'post'")
    if not 0.0 <= cfg.dropout_rate < 1.0:
        raise ValueError(f"dropout_rate={cfg.dropout_rate} outside [0, 1)")
    if len(cfg.sub_sampling_ratio) != len(cfg.d_out):
        raise ValueError("sub_sampling_ratio and d_out differ in length")


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def _read_run(run: Union[str, os.PathLike, Mapping]) -> Mapping:
    if not isinstance(run, Mapping):
        path = Path(run)
        run = json.loads((path / "config.json" if path.is_dir() else path).read_text())
    if run.get("pipeline") not in PIPELINES:
        raise ValueError(f"run config of pipeline {run.get('pipeline')!r}, "
                         f"not one of {PIPELINES}")
    return run


def _known_fields(block: Mapping, cls, ignored, what: str) -> dict:
    """The entries of `block` that are fields of `cls`; a key neither a field
    nor in `ignored` raises ValueError naming it."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(block) - known - set(ignored))
    if unknown:
        raise ValueError(f"run config {what} keys {unknown} are not known to the port")
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in block.items() if k in known}


def from_json(text: str) -> ModelConfig:
    """ModelConfig from a JSON object of its fields (lists become tuples)."""
    return ModelConfig(**_known_fields(json.loads(text), ModelConfig, (), "model"))


def from_run_config(run: Union[str, os.PathLike, Mapping]) -> ModelConfig:
    """The ModelConfig of a training run's `config.json`.

    `run` is the parsed JSON object, the file, or the run directory holding
    it. The fields of its "model" block map one for one; a field it lacks
    (older runs lack some) takes the default. A key of `IGNORED_KEYS` is
    dropped; any other unknown key raises ValueError naming it, as does a
    pipeline outside PIPELINES. The result passes `check_supported`.
    """
    run = _read_run(run)
    cfg = ModelConfig(**_known_fields(run["model"], ModelConfig, IGNORED_KEYS, "model"))
    check_supported(cfg)
    return cfg


def read_run_config(run: Union[str, os.PathLike, Mapping]) -> RunConfig:
    """The model, loss, training and eval configs, the pipeline and the
    voxel size of a training run's `config.json` (`run` as for
    `from_run_config`).

    The "loss", "train" and "eval" blocks map onto LossConfig, TrainConfig
    and EvalConfig field for field; of the "data" block only DATA_READ is
    read. A thres_radius <= 0 is filled as the JAX package's
    `Config.resolved` fills it: voxel_size * positive_pair_radius_multiplier.
    Keys in IGNORED_DATA_KEYS and IGNORED_TRAIN_KEYS are dropped; any other
    unknown key raises ValueError naming it.
    """
    run = _read_run(run)
    loss = LossConfig(**_known_fields(run.get("loss", {}), LossConfig, (), "loss"))
    train = TrainConfig(**_known_fields(run.get("train", {}), TrainConfig,
                                        IGNORED_TRAIN_KEYS, "train"))
    evaluation = EvalConfig(**_known_fields(run.get("eval", {}), EvalConfig, (), "eval"))
    data = run.get("data", {})
    unknown = sorted(set(data) - set(DATA_READ) - set(IGNORED_DATA_KEYS))
    if unknown:
        raise ValueError(f"run config data keys {unknown} are not known to the port")
    voxel_size = data.get("voxel_size", 0.3)      # deepsir_tpu/config.py:DataConfig defaults
    if loss.thres_radius <= 0:
        radius = voxel_size * data.get("positive_pair_radius_multiplier", 3.0)
        loss = replace(loss, thres_radius=radius)
    return RunConfig(from_run_config(run), loss, train, run["pipeline"], evaluation, voxel_size)
