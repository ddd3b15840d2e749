"""The port's configuration tree and its command-line flags.

A copy of deepsir_tpu/config.py: `ModelConfig`, `DataConfig`, `LossConfig`,
`TrainConfig`, `EvalConfig`, `ParallelConfig` and the top-level `Config`
with `resolved()`, the same field names, order and defaults, and after
them ModelConfig's two fields of the port's own (`PORT_FIELDS`), so that a
run's `config.json` (`config_dict(cfg)`) is the JAX package's for the same
flags; and the flag parsers of the train and test commands with
`config_from_args`. The port implements one slice of the model
configuration space (`check_supported`); any other value of an option
raises `NotImplementedError` naming the option instead of silently taking
another path. `from_run_config` reads the model block of the `config.json`
a training run writes beside its checkpoints, `read_run_config` all of it.

Precision: `compute_dtype="bfloat16"` runs the backbone and the
aggregation MLPs with bf16 Dense products (models/layers.py) and the
registration loop's searches K2/K3 on bf16 operands;
`inlier_compute_dtype="bfloat16"` runs the inlier RandLA's Dense products
in bf16. Every other product is fp32 grade whatever the three precision
names say ("default", "high" or "highest"): fp32 torch matmuls with TF32
off (deepsir_tpu_torch/__init__.py), and K2/K3 in 3xTF32 outside bf16
compute. That is what the JAX package computes on the CPU for every value
of `matmul_precision`, `inlier_matmul_precision` and
`matcher_matmul_precision`; the three fields are kept so that a run's
config maps one for one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping, NamedTuple, Optional, Tuple, Union

PIPELINES = ("label", "feat", "align")
DATASETS = ("3DMatch", "Oxford", "KITTI", "Synthetic")


def str2bool(v: str) -> bool:
    return str(v).lower() in ("true", "1", "yes")


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
    # knn_recall_target and matcher_method pick the JAX package's KNN and
    # matcher implementations on a TPU (both exact on the CPU, as the port's
    # kernels are); kept so that a run's config maps one for one
    knn_recall_target: float = 0.95
    matcher_method: str = "auto"
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
    # the JAX package's sinkhorn options, which nothing there reads either
    no_slack: bool = False
    num_sk_iter: int = 5
    # the port's own options (PORT_FIELDS), which the JAX package lacks:
    # the norm of every ConvUnit of the RandLA encoder and decoder, and the
    # label network's head ("randla": RandLA-Net's fc1, fc2, dropout, fc)
    randla_norm: str = "group"        # 'group' | 'batch'
    label_head: str = "deepsir"       # 'deepsir' | 'randla' (label pipeline only)


# ModelConfig's fields that the JAX package lacks, with their defaults: a
# run's config.json leaves each out while it holds its default
# (`config_dict`), so that it stays the JAX package's for the same flags
PORT_FIELDS = {f.name: f.default for f in dataclasses.fields(ModelConfig)
               if f.name in ("randla_norm", "label_head")}

INLIER_EXTRAS = ("dist", "recip")
COMPUTE_DTYPES = ("float32", "bfloat16")          # the JAX flags' choices
MATMUL_PRECISIONS = ("default", "high", "highest")
PPF_MIN_FEAT_LEN = 6                              # xyz, then the normals in 3:6

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
    """Training settings (deepsir_tpu/config.py:TrainConfig). The
    training step reads the learning-rate schedule; the train command the
    rest: validate_every < 0 counts epochs and 0 turns validation off."""
    lr: float = 1e-3
    lr_decay_epoch: int = 4
    lr_decay_ratio: float = 0.98
    lr_clip: float = 1e-4
    batch_size: int = 1
    summary_every: int = 3000
    validate_every: int = -2
    rte_thresh: float = 0.6           # the validation's success thresholds
    rre_thresh: float = 5.0
    resume: Optional[str] = None
    load_model_all: bool = False      # resume params and Adam state, else params by path
    seed: int = 0
    max_epochs: int = 200
    data_parallel: bool = False


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


@dataclass(frozen=True)
class DataConfig:
    """Dataset and augmentation settings (deepsir_tpu/config.py:DataConfig)."""
    dataset_path: str = "../data/"
    dataset_type: str = "KITTI"
    voxel_size: float = 0.3           # KITTI/Oxford 0.3, 3DMatch 0.03
    positive_pair_radius_multiplier: float = 3.0
    rot_mag: float = 45.0             # the augmentations' magnitudes
    xy_rot_scale: float = 0.1
    trans_mag: float = 2.0
    num_val: int = -1                 # validation subset (<= 0: all)
    num_workers: int = 8              # the loader's threads
    max_matches: int = 30000          # capacity of the GT match lists
    # ship host GT match lists (the list BCE) instead of the geometric labels
    gt_match_lists: bool = False
    oxford_pose_refine: bool = False  # ICP-refine the Oxford test poses
    synthetic_train_size: int = 256
    synthetic_eval_size: int = 32
    synthetic_noise: float = 0.01     # per-point gaussian noise
    synthetic_p_keep: float = 1.0     # half-space crop keep fraction
    synthetic_eval_offset: int = 0    # test-split pair-index offset

    @property
    def thres_radius(self) -> float:
        """The positive-pair radius."""
        return self.voxel_size * self.positive_pair_radius_multiplier


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout (deepsir_tpu/config.py:ParallelConfig); the port's
    commands run on one device and only carry it into the run's config."""
    data_axis: str = "data"
    model_axis: str = "model"
    num_data_shards: int = -1
    num_model_shards: int = 1


@dataclass(frozen=True)
class Config:
    """One run's whole configuration (deepsir_tpu/config.py:Config)."""
    pipeline: str = "align"           # 'label' | 'feat' | 'align'
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    logdir: str = "./logs"
    name: Optional[str] = None
    dev: bool = False
    debug: bool = False

    def __post_init__(self):
        if self.pipeline not in PIPELINES:
            raise ValueError(f"pipeline {self.pipeline!r}, not one of {PIPELINES}")

    def resolved(self) -> "Config":
        """The dataset's constants (3DMatch: voxel 0.03, thresholds 0.3 / 15,
        feat_len 3; Oxford: voxel 0.3, feat_len 3), thres_radius <= 0 filled
        from the data block, and under `dev` the smoke-run clamps (at most
        1024 points, 16 train and 4 eval synthetic pairs, 2 workers, 2
        epochs), as deepsir_tpu/config.py:Config.resolved does."""
        cfg = self
        ds = cfg.data.dataset_type
        if ds == "3DMatch":
            cfg = replace(cfg, data=replace(cfg.data, voxel_size=0.03),
                          eval=replace(cfg.eval, rte_thresh=0.3, rre_thresh=15.0))
            cfg = replace(cfg, model=replace(cfg.model, feat_len=3))
        elif ds == "Oxford":
            cfg = replace(cfg, data=replace(cfg.data, voxel_size=0.3))
            cfg = replace(cfg, model=replace(cfg.model, feat_len=3))
        if cfg.loss.thres_radius <= 0:
            cfg = replace(cfg, loss=replace(cfg.loss, thres_radius=cfg.data.thres_radius))
        if cfg.dev:
            cfg = replace(
                cfg,
                model=replace(cfg.model, num_points=min(cfg.model.num_points, 1024)),
                data=replace(cfg.data,
                             synthetic_train_size=min(cfg.data.synthetic_train_size, 16),
                             synthetic_eval_size=min(cfg.data.synthetic_eval_size, 4),
                             num_workers=min(cfg.data.num_workers, 2)),
                train=replace(cfg.train, max_epochs=min(cfg.train.max_epochs, 2)))
        return cfg

    def run_config(self) -> "RunConfig":
        """The RunConfig that the training step and the eval harness read."""
        return RunConfig(self.model, self.loss, self.train, self.pipeline, self.eval, self.data)


class RunConfig(NamedTuple):
    """What the training step and the eval harness read of a run's config.json."""
    model: ModelConfig
    loss: LossConfig
    train: TrainConfig
    pipeline: str = "align"           # one of PIPELINES
    eval: EvalConfig = EvalConfig()
    data: DataConfig = DataConfig()

    @property
    def voxel_size(self) -> float:
        """The data block's voxel size: the refiners' correspondence distance
        is twice it (deepsir_tpu/evaluation.py:134)."""
        return self.data.voxel_size


def inlier_extras(cfg: ModelConfig) -> Tuple[str, ...]:
    """The names in cfg.inlier_extra_feats, in the order of the string."""
    return tuple(s.strip() for s in cfg.inlier_extra_feats.split(",") if s.strip())


def _unported(name: str, value, ported: str) -> NotImplementedError:
    return NotImplementedError(f"ModelConfig.{name}={value!r} is not ported "
                               f"(the port implements {ported})")


def check_supported(cfg: ModelConfig, pipeline: Optional[str] = None) -> None:
    """Raise NotImplementedError naming the first option outside the slice.

    Besides the defaults the port implements:
    - `compute_dtype` and `inlier_compute_dtype` "float32" or "bfloat16";
      `matmul_precision`, `inlier_matmul_precision` and
      `matcher_matmul_precision` "default", "high" or "highest" (each read
      at fp32 grade, see the module docstring);
    - `use_ppf` with `feat_len >= 6` (the normals are channels 3:6);
    - `inlier_extra_feats` made of "dist" and "recip" (each at most once,
      any order), `mutual_check` with any `mutual_check_tol >= 0`;
    - `pyramid_order="morton"` with `knn_window_halo >= 1`;
    - `inlier_num_layers` L with 0 <= L < len(d_out), `inlier_num_knn` and
      `backbone_num_knn` >= 0, `refine_stride` >= 1, `absolute_pose_solve`;
    - `fc_norm` "group", "batch" or "none", `randla_skips` "pre" or "post";
    - `randla_norm` "group" or "batch" (the RandLA encoder's and decoder's
      units; the heads follow `fc_norm`), `label_head` "deepsir" or
      "randla", the latter under the label pipeline only: given a
      `pipeline`, "randla" under another raises.
    """
    for name in ("compute_dtype", "inlier_compute_dtype"):
        if getattr(cfg, name) not in COMPUTE_DTYPES:
            raise _unported(name, getattr(cfg, name), f"{COMPUTE_DTYPES}")
    for name in ("matmul_precision", "inlier_matmul_precision", "matcher_matmul_precision"):
        if getattr(cfg, name) not in MATMUL_PRECISIONS:
            raise _unported(name, getattr(cfg, name), f"{MATMUL_PRECISIONS}")
    if cfg.use_ppf and cfg.feat_len < PPF_MIN_FEAT_LEN:
        raise _unported("use_ppf", cfg.use_ppf,
                        f"use_ppf with feat_len >= {PPF_MIN_FEAT_LEN}, not "
                        f"feat_len={cfg.feat_len}: the normals are channels 3:6")
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
    if cfg.randla_norm not in ("group", "batch"):
        raise _unported("randla_norm", cfg.randla_norm, "'group' and 'batch'")
    if cfg.label_head not in ("deepsir", "randla"):
        raise _unported("label_head", cfg.label_head, "'deepsir' and 'randla'")
    if cfg.label_head == "randla" and pipeline not in (None, "label"):
        raise _unported("label_head", cfg.label_head,
                        f"label_head='randla' under the label pipeline only, not {pipeline!r}")
    if not 0.0 <= cfg.dropout_rate < 1.0:
        raise ValueError(f"dropout_rate={cfg.dropout_rate} outside [0, 1)")
    if len(cfg.sub_sampling_ratio) != len(cfg.d_out):
        raise ValueError("sub_sampling_ratio and d_out differ in length")


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def config_dict(cfg: "Config") -> dict:
    """`dataclasses.asdict(cfg)` without the model's `PORT_FIELDS` that hold
    their defaults: what a run writes as `config.json`, the JAX package's
    text for the same flags unless a port-only option is set."""
    out = dataclasses.asdict(cfg)
    for name, default in PORT_FIELDS.items():
        if out["model"][name] == default:
            del out["model"][name]
    return out


def _read_run(run: Union[str, os.PathLike, Mapping]) -> Mapping:
    if not isinstance(run, Mapping):
        path = Path(run)
        run = json.loads((path / "config.json" if path.is_dir() else path).read_text())
    if run.get("pipeline") not in PIPELINES:
        raise ValueError(f"run config of pipeline {run.get('pipeline')!r}, "
                         f"not one of {PIPELINES}")
    return run


def _known_fields(block: Mapping, cls, what: str) -> dict:
    """The entries of `block` as keyword arguments of `cls` (lists become
    tuples); a key that is not a field raises ValueError naming it."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(block) - known)
    if unknown:
        raise ValueError(f"run config {what} keys {unknown} are not known to the port")
    return {k: tuple(v) if isinstance(v, list) else v for k, v in block.items()}


def from_json(text: str) -> ModelConfig:
    """ModelConfig from a JSON object of its fields (lists become tuples)."""
    return ModelConfig(**_known_fields(json.loads(text), ModelConfig, "model"))


def from_run_config(run: Union[str, os.PathLike, Mapping]) -> ModelConfig:
    """The ModelConfig of a training run's `config.json`.

    `run` is the parsed JSON object, the file, or the run directory holding
    it. The fields of its "model" block map one for one; a field it lacks
    (older runs lack some) takes the default. An unknown key raises
    ValueError naming it, as does a pipeline outside PIPELINES. The result
    passes `check_supported`.
    """
    run = _read_run(run)
    cfg = ModelConfig(**_known_fields(run["model"], ModelConfig, "model"))
    check_supported(cfg, run["pipeline"])
    return cfg


def read_run_config(run: Union[str, os.PathLike, Mapping]) -> RunConfig:
    """The model, loss, training, eval and data configs and the pipeline of
    a training run's `config.json` (`run` as for `from_run_config`).

    Each block maps onto its dataclass field for field. A thres_radius <= 0
    is filled as the JAX package's `Config.resolved` fills it: voxel_size *
    positive_pair_radius_multiplier. An unknown key raises ValueError
    naming it.
    """
    run = _read_run(run)
    loss, train, evaluation, data = (
        cls(**_known_fields(run.get(block, {}), cls, block))
        for block, cls in (("loss", LossConfig), ("train", TrainConfig), ("eval", EvalConfig),
                           ("data", DataConfig)))
    if loss.thres_radius <= 0:
        loss = replace(loss, thres_radius=data.thres_radius)
    return RunConfig(from_run_config(run), loss, train, run["pipeline"], evaluation, data)


# --------------------------------------------------------------------------
# The commands' flags: the JAX package's, and --device
# --------------------------------------------------------------------------

def _add_net_arguments(p: argparse.ArgumentParser) -> None:
    """Flags shared by the train and test commands
    (deepsir_tpu/config.py:_add_net_arguments), and --device."""
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; 'cuda' needs a card")
    p.add_argument("--logdir", type=str, default="./logs")
    p.add_argument("--dev", action="store_true")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--dataset_path", type=str, default="../data/")
    p.add_argument("--dataset_type", default="KITTI", choices=list(DATASETS))
    p.add_argument("--feat_len", type=int, default=4)
    p.add_argument("--pipeline", type=str, default="align", choices=list(PIPELINES))
    p.add_argument("--use_ppf", type=str2bool, default=False)
    p.add_argument("--voxel_size", type=float, default=0.3)
    p.add_argument("--positive_pair_radius_multiplier", type=float, default=3.0)
    p.add_argument("--rot_mag", type=float, default=45.0)
    p.add_argument("--xy_rot_scale", type=float, default=0.1)
    p.add_argument("--trans_mag", type=float, default=2.0)
    p.add_argument("--synthetic_train_size", type=int, default=256)
    p.add_argument("--synthetic_eval_size", type=int, default=32)
    p.add_argument("--synthetic_noise", type=float, default=0.01)
    p.add_argument("--synthetic_p_keep", type=float, default=1.0)
    p.add_argument("--synthetic_eval_offset", type=int, default=0)
    p.add_argument("--thres_radius", type=float, default=-1.0)
    p.add_argument("--gt_match_lists", type=str2bool, default=False)
    p.add_argument("--oxford_pose_refine", type=str2bool, default=False)
    p.add_argument("--det_loss_weight", type=float, default=1.0)
    p.add_argument("--circle_loss_tile", type=int, default=0)
    p.add_argument("--overlap_det_mask", type=str2bool, default=False)
    p.add_argument("--chamfer_loss_weight", type=float, default=0.0)
    p.add_argument("--feat_loss_weight", type=float, default=0.0)
    p.add_argument("--loss_type", type=str, choices=["mse", "mae"], default="mae")
    p.add_argument("--wt_ptDist_loss", type=float, default=1.0)
    p.add_argument("--wt_inlier_loss", type=float, default=1.0)
    p.add_argument("--wt_pose_loss", type=float, default=0.0)
    p.add_argument("--clip_weight_thresh", type=float, default=0.0)
    p.add_argument("--absolute_pose_solve", type=str2bool, default=False)
    p.add_argument("--mutual_check", type=str2bool, default=False)
    p.add_argument("--mutual_check_tol", type=float, default=0.0)
    p.add_argument("--loss_discount_factor", type=float, default=0.5)
    p.add_argument("--no_slack", action="store_true")
    p.add_argument("--num_sk_iter", type=int, default=5)
    p.add_argument("--num_train_reg_iter", type=int, default=2)
    p.add_argument("--num_reg_iter", type=int, default=5)
    p.add_argument("--num_points", type=int, default=18000)
    p.add_argument("--num_sub", type=int, default=-1)
    p.add_argument("--num_knn", type=int, default=16)
    p.add_argument("--sub_sampling_ratio", type=int, nargs="+", default=[4, 4, 4, 4])
    p.add_argument("--d_out", type=int, nargs="+", default=[16, 64, 128, 256])
    p.add_argument("--randla_skips", type=str, default="pre", choices=["pre", "post"])
    p.add_argument("--fc_norm", type=str, default="group", choices=["group", "batch", "none"])
    p.add_argument("--randla_norm", type=str, default="group", choices=["group", "batch"])
    p.add_argument("--label_head", type=str, default="deepsir", choices=["deepsir", "randla"])
    p.add_argument("--out_feat_dim", type=int, default=64)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--knn_recall_target", type=float, default=0.95)
    p.add_argument("--matcher_method", type=str, default="auto", choices=["auto", "xla"])
    for name in ("matmul_precision", "inlier_matmul_precision", "matcher_matmul_precision"):
        p.add_argument(f"--{name}", type=str,
                       default="highest" if name == "matmul_precision" else "default",
                       choices=["default", "high", "highest"])
    p.add_argument("--inlier_num_layers", type=int, default=0)
    p.add_argument("--inlier_num_knn", type=int, default=0)
    p.add_argument("--backbone_num_knn", type=int, default=0)
    p.add_argument("--inlier_extra_feats", type=str, default="")
    p.add_argument("--inlier_compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--refine_stride", type=int, default=1)
    p.add_argument("--pyramid_order", type=str, default="shuffled",
                   choices=["shuffled", "morton"])
    p.add_argument("--knn_window_halo", type=int, default=1)
    p.add_argument("-bs", "--batch_size", type=int, default=1)
    p.add_argument("-nv", "--num_val", type=int, default=-1)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--load_model_all", action="store_true")


def train_argument_parser() -> argparse.ArgumentParser:
    """The train command's flags (deepsir_tpu/config.py:train_argument_parser)."""
    p = argparse.ArgumentParser(description="Train")
    _add_net_arguments(p)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_decay_epoch", type=int, default=4)
    p.add_argument("--lr_decay_ratio", type=float, default=0.98)
    p.add_argument("-su", "--summary_every", type=int, default=3000)
    p.add_argument("-v", "--validate_every", type=int, default=-2)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--rte_thresh", type=float, default=0.6)
    p.add_argument("--rre_thresh", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_epochs", type=int, default=200)
    p.add_argument("--data_parallel", type=str2bool, default=False)
    return p


def eval_argument_parser() -> argparse.ArgumentParser:
    """The test command's flags (deepsir_tpu/config.py:eval_argument_parser)."""
    p = argparse.ArgumentParser(description="Evaluation")
    _add_net_arguments(p)
    p.add_argument("--transform_file", type=str, default=None)
    p.add_argument("--eval_save_path", type=str, default="./out/")
    p.add_argument("--use_finetune", type=str2bool, default=False)
    p.add_argument("--use_icp", type=str2bool, default=False)
    p.add_argument("--use_ransac", type=str2bool, default=False)
    p.add_argument("--transfer_dtype", type=str, default="float32",
                   choices=["float32", "float16"])
    p.add_argument("--pose_average_last", type=int, default=0)
    return p


def _fields_from(args: argparse.Namespace, cls, skip: Tuple[str, ...] = ()):
    """An instance of `cls` with each field not in `skip` the flag of its
    name where the parser has one, else the default."""
    return cls(**{f.name: tuple(v) if isinstance(v, list) else v
                  for f in dataclasses.fields(cls) if f.name not in skip
                  for v in [getattr(args, f.name, f.default)]})


def config_from_args(args: argparse.Namespace) -> Config:
    """The resolved Config of parsed command-line flags
    (deepsir_tpu/config.py:config_from_args); --device is not part of it.
    EvalConfig's batch size and thresholds are no flags of their own (the
    flags of those names set TrainConfig's)."""
    return Config(pipeline=args.pipeline, model=_fields_from(args, ModelConfig),
                  data=_fields_from(args, DataConfig), loss=_fields_from(args, LossConfig),
                  train=_fields_from(args, TrainConfig),
                  eval=_fields_from(args, EvalConfig,
                                    skip=("batch_size", "rte_thresh", "rre_thresh")),
                  logdir=args.logdir, name=args.name, dev=args.dev,
                  debug=args.debug).resolved()
