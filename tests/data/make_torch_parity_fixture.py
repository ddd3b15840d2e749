"""Write the JAX package's align forward on tiny configs, for holding the
PyTorch port against it where JAX is absent:
- tests/data/torch_parity_small.npz: the default options (MODEL);
- tests/data/torch_parity_paths.npz: the `dist,recip` inlier channels, the
  relaxed mutual gate and the Morton pyramid with windowed KNN
  (MODEL_PATHS), at 4096 points so that level 0 is really windowed; its
  clouds are Morton-sorted before the forward and its index arrays stored
  as uint16 to keep the file small;
- tests/data/torch_parity_ckpt.npz: the tracked align checkpoints' eval
  forward on their run's synthetic pairs;
- tests/data/torch_parity_train.npz: two training steps of the staged align
  checkpoint, resumed with its Adam state, on 2 of those pairs at 1024
  points (`train`);
- tests/data/torch_parity_stages.npz: the staged label and feat checkpoints'
  eval forward and one resumed training step each, on synthetic pairs
  with labels at 1024 points, and the leaf counts of the staged chain
  (`stages`);
- tests/data/torch_parity_eval.npz: the eval harness's refiners
  (`evaluation.pose_optimization`) on the staged align checkpoint's forward
  of the checkpoint pairs at 1024 points under each setting of
  chip_smoke.EVAL_SETTINGS, with their per-pair metrics, JAX's RANSAC
  draws, the refiners' float64 references (JAX's finetune in x64, a numpy
  ICP over exact nearest neighbours), and the label and feat sweeps on the
  stages fixture's pairs (`eval`).

- tests/data/torch_parity_precision.npz: the staged align checkpoint's
  forward on the checkpoint pairs at 1024 points under bf16 compute (B16;
  B16F with the `dist,recip` channels, the inlier input layer widened by
  two seeded rows), bf16 inlier net only (I16) and their fp32
  counterparts, with the bf16 search through the `matcher` hook, and one
  align training step in bf16 and in fp32 (`precision`).

- tests/data/torch_parity_parallel.npz: the JAX package's data-parallel
  steps (deepsir_tpu/parallel/sharded.py) on the 8-device virtual CPU mesh
  at 256 points, over exact pyramids (stored with it): the sharded train
  step of the align, label (`fc_norm="batch"`, ignored labels) and feat
  pipelines on a (4, 1) mesh, and the sharded align eval step on a (2, 2)
  mesh, with and without the mutual gate (`parallel`; its JAX steps take
  ~60-90 s each to compile).

Run on the CPU with JAX installed:
    python tests/data/make_torch_parity_fixture.py [small] [paths] [ckpt] [train] [stages] [eval] [cli] [precision] [parallel]

Each file holds the model config (`model_json`), the flax params
(`param/<path>`), the input arrays, both clouds' pyramid indices and the
forward's outputs. tests/test_torch_align.py and
tests/test_torch_align_paths.py regenerate them in memory and fail when a
committed file differs.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

import numpy as np

OUT = Path(__file__).with_name("torch_parity_small.npz")
MODEL = dict(feat_len=3, num_points=1024, num_knn=8, sub_sampling_ratio=(4, 4),
             d_out=(8, 16), out_feat_dim=16, num_classes=5, num_reg_iter=2)
OUT_PATHS = Path(__file__).with_name("torch_parity_paths.npz")
MODEL_PATHS = dict(MODEL, num_points=4096, inlier_extra_feats="dist,recip",
                   clip_weight_thresh=0.05, mutual_check=True, mutual_check_tol=0.6,
                   pyramid_order="morton", knn_window_halo=1)
BATCH = 2
SEED = 0

OUT_CKPT = Path(__file__).with_name("torch_parity_ckpt.npz")
ROOT = Path(__file__).resolve().parents[2]
CKPTS = ("logs_r3/staged_po/260817_191109_align", "logs_r3/260817_133900_align_po")
CKPT_PAIRS = ((1024, 8), (18000, 2))          # (points per cloud, pairs)


def make_arrays(seed: int = SEED, model: Dict = MODEL) -> Dict[str, np.ndarray]:
    """src: unit-normal clouds; ref: each src cloud rotated ~10 deg about a
    random axis, shifted, jittered and reshuffled. Under Morton order both
    are then curve-sorted, as the data layer does."""
    rng = np.random.default_rng(seed)
    n = model["num_points"]
    src = rng.normal(size=(BATCH, n, 3)).astype(np.float32)
    ref = np.empty_like(src)
    for b in range(BATCH):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = np.deg2rad(10.0)
        kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                       [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(ang) * kx + (1 - np.cos(ang)) * kx @ kx
        moved = src[b] @ rot.T + rng.normal(scale=0.2, size=3)
        moved += rng.normal(scale=0.01, size=moved.shape)
        ref[b] = moved[rng.permutation(n)].astype(np.float32)
    if model.get("pyramid_order") == "morton":
        from deepsir_tpu.ops.morton import morton_order_np
        src, ref = (np.stack([c[morton_order_np(c)] for c in x]) for x in (src, ref))
    return {"points_src": src, "points_ref": ref,
            "transform_gt": np.tile(np.eye(3, 4, dtype=np.float32), (BATCH, 1, 1))}


def _setup(model_cfg: Dict = MODEL):
    from deepsir_tpu.config import Config, ModelConfig
    from deepsir_tpu.models import ForwardOptions, Network
    cfg = Config(pipeline="align", model=ModelConfig(**model_cfg))
    model = Network(cfg.model, pipeline="align")
    opts = ForwardOptions(num_iter=model_cfg["num_reg_iter"], clip_weight=True)
    return cfg, model, opts


def build(seed: int = SEED, model_cfg: Dict = MODEL,
          index_dtype=None) -> Dict[str, np.ndarray]:
    """Run JAX on the CPU; returns the fixture's arrays, with the index
    arrays cast to `index_dtype` if given."""
    import jax
    from deepsir_tpu.training import device_batch
    cfg, model, opts = _setup(model_cfg)
    arrays = make_arrays(seed, model_cfg)
    params = jax.jit(lambda r, a: model.init(r, device_batch(cfg, a), opts))(
        jax.random.PRNGKey(seed), arrays)

    @jax.jit
    def fwd(p, a):
        batch = device_batch(cfg, a)
        _, out = model.apply(p, batch, opts, train=False)
        return batch.pyramid_src, batch.pyramid_ref, out

    pyr_src, pyr_ref, out = jax.device_get(fwd(params, arrays))
    fixture = dict(arrays, model_json=np.asarray(json.dumps(model_cfg)))
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    for path, leaf in flat:
        fixture["param/" + "/".join(p.key for p in path)] = np.asarray(leaf)

    def index(a):
        return np.asarray(a) if index_dtype is None else np.asarray(a).astype(index_dtype)

    for side, pyr in (("src", pyr_src), ("ref", pyr_ref)):
        for lvl in range(len(model_cfg["d_out"])):
            fixture[f"{side}_neigh_idx_{lvl}"] = index(pyr.neigh_idx[lvl])
            fixture[f"{side}_interp_idx_{lvl}"] = index(pyr.interp_idx[lvl])
    fixture.update(transforms=np.asarray(out.transforms),
                   pred_idx=index(out.pred_idx),
                   inlier_logits=np.asarray(out.inlier_logits),
                   invalid=np.asarray(out.invalid))
    return fixture


def build_paths(seed: int = SEED) -> Dict[str, np.ndarray]:
    """The second fixture's arrays: MODEL_PATHS, index arrays as uint16."""
    return build(seed, MODEL_PATHS, np.uint16)


def run_config(ckpt: str = CKPTS[0], num_points: int = None):
    """The JAX Config of a tracked run's config.json (its pipeline, model,
    data, loss, train and eval blocks), at `num_points`."""
    from deepsir_tpu.config import (Config, DataConfig, EvalConfig, LossConfig, ModelConfig,
                                    TrainConfig)
    run = json.loads((ROOT / ckpt / "config.json").read_text())
    model = {k: tuple(v) if isinstance(v, list) else v for k, v in run["model"].items()}
    if num_points is not None:
        model["num_points"] = num_points
    return Config(pipeline=run["pipeline"], model=ModelConfig(**model),
                  data=DataConfig(**run["data"]), loss=LossConfig(**run["loss"]),
                  train=TrainConfig(**run["train"]),
                  eval=EvalConfig(**run["eval"])).resolved()


def ckpt_pairs(num_points: int, pairs: int) -> Dict[str, np.ndarray]:
    """The first `pairs` test pairs of the staged checkpoint's synthetic data
    at `num_points`: the arrays the eval feeds device_batch."""
    from deepsir_tpu.data.base import make_pair_arrays
    from deepsir_tpu.data.datasets import get_test_dataset
    ds = get_test_dataset(run_config(num_points=num_points))
    batch = make_pair_arrays([ds.get_sample(i, np.random.default_rng(i)) for i in range(pairs)])
    return {k: batch[k] for k in ("points_src", "points_ref", "transform_gt",
                                  "mask_src", "mask_ref")}


def pack_cloud(points: np.ndarray, mask: np.ndarray):
    """(raw rows of each cloud, zero-padded to the longest; raw counts).
    The data layer pads a cloud by tiling its raw rows (fixed_resample);
    chip_smoke.checkpoint_arrays undoes this."""
    raw = mask.sum(axis=1).astype(np.int64)
    rows = np.zeros((len(points), raw.max(), points.shape[-1]), points.dtype)
    for b, n in enumerate(raw):
        assert (mask[b, :n] == 1).all() and (mask[b, n:] == 0).all()
        rows[b, :n] = points[b, :n]
    return rows, raw


def exact_knn(query: np.ndarray, ref: np.ndarray, k: int) -> np.ndarray:
    """(B, N, 3) x (B, M, 3) -> the k nearest refs (B, N, k), ranked by
    float64 distance with ties to the lower index."""
    d = ((query[:, :, None, :].astype(np.float64) - ref[:, None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=-1, kind="stable")[..., :k].astype(np.int32)


def exact_pyramid(xyz: np.ndarray, num_knn: int, ratios):
    """The shuffled-order pyramid of clouds (B, N, 3) over exact_knn."""
    from deepsir_tpu.ops.pyramid import Pyramid
    levels = ([], [], [], [])
    pc = xyz
    for r in ratios:
        n_next = pc.shape[1] // r
        neigh = exact_knn(pc, pc, num_knn)
        for out, value in zip(levels, (pc, neigh, neigh[:, :n_next],
                                       exact_knn(pc, pc[:, :n_next], 1)[..., 0])):
            out.append(value)
        pc = pc[:, :n_next]
    return Pyramid(*(tuple(v) for v in levels))


def align_params(arrays, ckpt: str = CKPTS[0]):
    """A tracked align checkpoint's params (partial_restore, every leaf)."""
    import jax
    from deepsir_tpu.models import ForwardOptions, Network
    from deepsir_tpu.training import device_batch
    from deepsir_tpu.utils.checkpoint import partial_restore
    cfg = run_config(ckpt, arrays["points_src"].shape[1])
    model = Network(cfg.model, pipeline="align")
    opts = ForwardOptions(num_iter=cfg.model.num_reg_iter, clip_weight=True)
    target = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0),
                                                 device_batch(cfg, a), opts), arrays)
    target = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), target)
    params, loaded = partial_restore(str(ROOT / ckpt / "ckpt"), target)
    assert loaded == len(jax.tree_util.tree_leaves(target)), loaded
    return params


def ckpt_outputs(ckpt: str, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The JAX forward of a tracked align checkpoint on `arrays` (5
    iterations, clip_weight): transforms, matches and `invalid` over exact
    pyramids; pose errors and success flags as the eval runs it."""
    import jax
    from deepsir_tpu.math.se3 import pose_error
    from deepsir_tpu.models import ForwardOptions, Network
    from deepsir_tpu.models.network import PairBatch
    from deepsir_tpu.training import device_batch
    cfg = run_config(ckpt, arrays["points_src"].shape[1])
    model = Network(cfg.model, pipeline="align")
    opts = ForwardOptions(num_iter=cfg.model.num_reg_iter, clip_weight=True)
    params = align_params(arrays, ckpt)

    m = cfg.model
    pyramids = [exact_pyramid(arrays[f"points_{s}"][..., :3], m.num_knn, m.sub_sampling_ratio)
                for s in ("src", "ref")]

    @jax.jit
    def exact(p, a, pyr_src, pyr_ref):
        batch = PairBatch(a["points_src"], a["points_ref"], pyr_src, pyr_ref,
                          a["transform_gt"], mask_src=a["mask_src"], mask_ref=a["mask_ref"])
        _, out = model.apply(p, batch, opts, train=False)
        return out.transforms, out.pred_idx, out.invalid

    @jax.jit
    def eval_forward(p, a):
        _, out = model.apply(p, device_batch(cfg, a), opts, train=False)
        return out.transforms[-1]

    transforms, idx, invalid = jax.device_get(exact(params, arrays, *pyramids))
    final = jax.device_get(eval_forward(params, arrays))
    rre, rte = (np.asarray(e) for e in pose_error(arrays["transform_gt"], final))
    succ = (rte < cfg.eval.rte_thresh) & (rre < cfg.eval.rre_thresh)
    return {"transforms": np.asarray(transforms), "pred_idx": np.asarray(idx, np.uint16),
            "invalid": np.asarray(invalid), "rre": rre, "rte": rte, "succ": succ}


def build_ckpt() -> Dict[str, np.ndarray]:
    """The checkpoint fixture's arrays."""
    fixture = {"checkpoints": np.asarray(CKPTS)}
    for n, pairs in CKPT_PAIRS:
        arrays = ckpt_pairs(n, pairs)
        fixture[f"n{n}_transform_gt"] = arrays["transform_gt"]
        for side in ("src", "ref"):
            rows, raw = pack_cloud(arrays[f"points_{side}"], arrays[f"mask_{side}"])
            fixture[f"n{n}_{side}_rows"], fixture[f"n{n}_{side}_raw"] = rows, raw
    from chip_smoke import checkpoint_arrays
    arrays = checkpoint_arrays(fixture, 1024)
    for i, ckpt in enumerate(CKPTS):
        for key, value in ckpt_outputs(ckpt, arrays).items():
            fixture[f"ckpt{i}_{key}"] = value
    return fixture


OUT_TRAIN = Path(__file__).with_name("torch_parity_train.npz")
TRAIN_PAIRS, TRAIN_STEPS = 2, 2
# the staged run's loader: 256 synthetic training pairs in batches of 8
TRAIN_STEPS_PER_EPOCH = 32


def build_train() -> Dict[str, np.ndarray]:
    """Two align training steps of the JAX package, as make_train_step takes
    them, from the staged checkpoint's params and optimizer state, with its
    run config at dropout_rate 0, on the first TRAIN_PAIRS checkpoint pairs
    at 1024 points over exact pyramids: `jax.value_and_grad(compute_loss)`,
    then `tx.update` where the step is not skipped. Stores per step the loss
    terms, `skipped`, the lr and the matches; the inlier grads of step 1
    and the inlier params after the last step, each leaf whole or, above
    chip_smoke.SUMMARY_ENTRIES entries, summarised (chip_smoke.summarize_leaf)."""
    import jax
    import optax
    from flax.traverse_util import flatten_dict
    from chip_smoke import summarize_leaf
    from deepsir_tpu.config import replace
    from deepsir_tpu.models import ForwardOptions
    from deepsir_tpu.models.network import PairBatch
    from deepsir_tpu.training import (compute_loss, create_train_state, make_lr_schedule,
                                      make_optimizer)
    from deepsir_tpu.utils.checkpoint import CheckPointManager
    cfg = run_config(num_points=1024)
    cfg = replace(cfg, model=replace(cfg.model, dropout_rate=0.0))
    arrays = ckpt_pairs(1024, TRAIN_PAIRS)
    model, template = create_train_state(cfg, arrays, TRAIN_STEPS_PER_EPOCH)
    ckpt = str(ROOT / CKPTS[0] / "ckpt")
    state, _ = CheckPointManager(ckpt).load(ckpt, template)
    m = cfg.model
    pyramids = [exact_pyramid(arrays[f"points_{s}"][..., :3], m.num_knn, m.sub_sampling_ratio)
                for s in ("src", "ref")]
    batch = PairBatch(arrays["points_src"], arrays["points_ref"], *pyramids,
                      arrays["transform_gt"], mask_src=arrays["mask_src"],
                      mask_ref=arrays["mask_ref"])
    opts = ForwardOptions(num_iter=m.num_train_reg_iter)
    rng = jax.random.PRNGKey(0)
    tx = make_optimizer(cfg, TRAIN_STEPS_PER_EPOCH)
    schedule = make_lr_schedule(cfg, TRAIN_STEPS_PER_EPOCH)

    @jax.jit
    def step_of(p):
        (loss, aux), g = jax.value_and_grad(
            lambda q: compute_loss(cfg, model, q, batch, opts, True, rng), has_aux=True)(p)
        _, out = model.apply(p, batch, opts, train=True, rngs={"dropout": rng})
        return loss, aux, g, out.pred_idx

    def inlier(tree):
        flat = flatten_dict(jax.device_get(tree)["params"]["inlier_model"])
        return {"inlier_model/" + "/".join(k): np.asarray(v) for k, v in flat.items()}

    params, opt_state = state.params, state.opt_state
    count = int(opt_state.inner_states["train"].inner_state[1].count)
    fixture = dict(arrays, count=np.asarray(count), steps=np.asarray(TRAIN_STEPS),
                   steps_per_epoch=np.asarray(TRAIN_STEPS_PER_EPOCH))
    for s in range(TRAIN_STEPS):
        loss, aux, grads, pred = jax.device_get(step_of(params))
        ok = (np.isfinite(loss) and not aux["invalid"]
              and all(np.isfinite(g).all() for g in jax.tree_util.tree_leaves(grads)))
        fixture.update({f"step{s}_loss": np.asarray(loss), f"step{s}_skipped": np.asarray(not ok),
                        f"step{s}_lr": np.asarray(schedule(count)),
                        f"step{s}_pred_idx": np.asarray(pred, np.uint16)})
        for key, value in aux["losses"].items():
            fixture[f"step{s}_term/{key}"] = np.asarray(value)
        if s == 0:
            for path, leaf in inlier(grads).items():
                for field, value in summarize_leaf(leaf).items():
                    fixture[f"grad0/{path}/{field}"] = value
        if ok:
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            count += 1
    for path, leaf in inlier(params).items():
        for field, value in summarize_leaf(leaf).items():
            fixture[f"param{TRAIN_STEPS}/{path}/{field}"] = value
    return fixture


OUT_STAGES = Path(__file__).with_name("torch_parity_stages.npz")
# the staged regimen's label and feat runs; the align run is CKPTS[0]
STAGES = {"label": "logs_r3/staged_po/260817_185436_label",
          "feat": "logs_r3/staged_po/260817_185849_feat"}
STAGE_PAIRS = 2
FEAT_ROW_STRIDE = 8       # the fixture keeps every 8th descriptor row (size)
# a trained leaf above this many entries is summarised (the file's size)
STAGE_FULL_ENTRIES = 512


def stage_pairs(num_points: int, pairs: int) -> Dict[str, np.ndarray]:
    """The first `pairs` test pairs of the label run's synthetic data at
    `num_points`, with their semantic labels: the arrays device_batch
    takes (clouds and labels tiled to num_points, as the data layer pads)."""
    from deepsir_tpu.data.base import make_pair_arrays
    from deepsir_tpu.data.datasets import get_test_dataset
    ds = get_test_dataset(run_config(STAGES["label"], num_points))
    batch = make_pair_arrays([ds.get_sample(i, np.random.default_rng(i)) for i in range(pairs)])
    return {k: batch[k] for k in ("points_src", "points_ref", "transform_gt",
                                  "labels_src", "labels_ref")}


def _exact_batch(cfg, arrays):
    from deepsir_tpu.models.network import PairBatch
    m = cfg.model
    pyramids = [exact_pyramid(arrays[f"points_{s}"][..., :3], m.num_knn, m.sub_sampling_ratio)
                for s in ("src", "ref")]
    return PairBatch(arrays["points_src"], arrays["points_ref"], *pyramids,
                     arrays["transform_gt"], labels_src=arrays["labels_src"],
                     labels_ref=arrays["labels_ref"])


def stage_outputs(pipeline: str, arrays) -> Dict[str, np.ndarray]:
    """The JAX eval forward (make_forward_step: forward_pair, train=False)
    of a staged checkpoint over exact pyramids, and its loss: label the
    logits (and the semantic loss and accuracy over the labels); feat the
    scores, every FEAT_ROW_STRIDE-th descriptor row and det_des_loss."""
    import jax
    from deepsir_tpu.losses import det_des_loss, semantic_loss
    from deepsir_tpu.models import Network
    from deepsir_tpu.utils.checkpoint import partial_restore
    from deepsir_tpu.training import device_batch
    cfg = run_config(STAGES[pipeline], arrays["points_src"].shape[1])
    model = Network(cfg.model, pipeline=pipeline)
    target = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0),
                                                 device_batch(cfg, a)), arrays)
    target = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), target)
    params, loaded = partial_restore(str(ROOT / STAGES[pipeline] / "ckpt"), target)
    assert loaded == len(jax.tree_util.tree_leaves(target)), loaded
    _, out = jax.device_get(jax.jit(lambda p, b: model.apply(p, b, train=False))(
        params, _exact_batch(cfg, arrays)))
    if pipeline == "label":
        losses = [semantic_loss(out.logits_src, arrays["labels_src"]),
                  semantic_loss(out.logits_ref, arrays["labels_ref"])]
        return {"logits_src": out.logits_src, "logits_ref": out.logits_ref,
                "loss": np.asarray(losses[0][0] + losses[1][0]),
                "acc": np.asarray((losses[0][1] + losses[1][1]) / 2)}
    loss, acc = det_des_loss(out.feat_src, out.feat_ref, out.xyz_src, out.xyz_ref,
                             out.score_src, out.score_ref, arrays["transform_gt"], cfg.loss)
    return {"score_src": out.score_src, "score_ref": out.score_ref,
            "feat_src_rows": out.feat_src[:, ::FEAT_ROW_STRIDE],
            "feat_ref_rows": out.feat_ref[:, ::FEAT_ROW_STRIDE],
            "loss": np.asarray(loss), "acc": np.asarray(acc)}


def stage_step(pipeline: str, arrays) -> Dict[str, np.ndarray]:
    """One training step of a staged checkpoint resumed with its Adam state
    (CheckPointManager.load), its run config at dropout_rate 0, over exact
    pyramids: `jax.value_and_grad(compute_loss)`, then `tx.update`, in
    float32 and again with every float upcast to float64 (x64). Stores the
    count, the float32 loss and accuracy, the lr and `skipped`; the trained
    leaves' grads and params after the step of the float64 run
    (chip_smoke.summarize_leaf, whole up to STAGE_FULL_ENTRIES entries);
    and how far the float32 run's grads are from them (the largest
    chip_smoke.leaf_error): the feat step's float32 grads of mlp_feat are
    ~1e-3 of the leaf's scale off, more than the port's, so the float64 run
    is the reference."""
    import jax
    import optax
    from flax.traverse_util import flatten_dict
    from chip_smoke import leaf_error, summarize_leaf
    from deepsir_tpu.config import replace
    from deepsir_tpu.training import (TRAINABLE_GROUPS, compute_loss, create_train_state,
                                      make_lr_schedule, make_optimizer)
    from deepsir_tpu.utils.checkpoint import CheckPointManager
    cfg = run_config(STAGES[pipeline], arrays["points_src"].shape[1])
    cfg = replace(cfg, model=replace(cfg.model, dropout_rate=0.0))
    model, template = create_train_state(cfg, arrays, TRAIN_STEPS_PER_EPOCH)
    ckpt = str(ROOT / STAGES[pipeline] / "ckpt")
    state, _ = CheckPointManager(ckpt).load(ckpt, template)
    tx = make_optimizer(cfg, TRAIN_STEPS_PER_EPOCH)
    rng = jax.random.PRNGKey(0)

    def step(params, opt_state, batch):
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda q: compute_loss(cfg, model, q, batch, None, True, rng), has_aux=True))(params)
        updates, _ = tx.update(grads, opt_state, params)
        return jax.device_get((loss, aux, grads, optax.apply_updates(params, updates)))

    def trained(tree):
        flat = flatten_dict(tree["params"])
        return {"/".join(k): np.asarray(v) for k, v in flat.items()
                if set(k) & TRAINABLE_GROUPS[pipeline]}

    batch = _exact_batch(cfg, arrays)
    loss, aux, grads32, _ = step(state.params, state.opt_state, batch)
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else a,
                tree)
        _, _, grads, params = step(f64(state.params), f64(state.opt_state), f64(batch))
    ok = np.isfinite(loss) and all(np.isfinite(g).all()
                                   for g in jax.tree_util.tree_leaves(grads32))
    count = int(state.opt_state.inner_states["train"].inner_state[1].count)
    grads, grads32 = trained(grads), trained(grads32)
    fixture = {"count": np.asarray(count), "step_loss": np.asarray(loss),
               "step_acc": np.asarray(aux["acc"]), "step_skipped": np.asarray(not ok),
               "step_lr": np.asarray(make_lr_schedule(cfg, TRAIN_STEPS_PER_EPOCH)(count)),
               "jax_fp32_grad_rel_err": np.asarray(max(
                   leaf_error(grads32[k], {"full": grads[k]}) for k in grads))}
    for prefix, leaves in (("grad", grads), ("param1", trained(params))):
        for path, leaf in leaves.items():
            for field, value in summarize_leaf(leaf, STAGE_FULL_ENTRIES).items():
                fixture[f"{prefix}/{path}/{field}"] = value
    return fixture


def stage_chain() -> Dict[str, np.ndarray]:
    """The leaves JAX's partial_restore loads along the staged chain: label
    into a feat model, feat into an align model, and each stage into its own."""
    import jax
    from deepsir_tpu.models import Network
    from deepsir_tpu.training import device_batch
    from deepsir_tpu.utils.checkpoint import partial_restore
    runs = dict(STAGES, align=CKPTS[0])
    arrays = stage_pairs(1024, 1)
    counts = {}
    for into, source in (("feat", "label"), ("align", "feat"), ("label", "label"),
                         ("feat", "feat"), ("align", "align")):
        cfg = run_config(runs[into], 1024)
        model = Network(cfg.model, pipeline=into)
        target = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0),
                                                     device_batch(cfg, a)), arrays)
        target = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), target)
        _, loaded = partial_restore(str(ROOT / runs[source] / "ckpt"), target)
        counts[f"chain/{source}->{into}"] = np.asarray(
            [loaded, len(jax.tree_util.tree_leaves(target))])
    return counts


def build_stages() -> Dict[str, np.ndarray]:
    """The stages fixture's arrays: the pairs (with labels), each staged
    checkpoint's forward (`<pipeline>/...`) and resumed step
    (`<pipeline>_step/...`), and the chain's leaf counts."""
    arrays = stage_pairs(1024, STAGE_PAIRS)
    fixture = dict(arrays, stages=np.asarray([STAGES["label"], STAGES["feat"], CKPTS[0]]))
    for pipeline in ("label", "feat"):
        for key, value in stage_outputs(pipeline, arrays).items():
            fixture[f"{pipeline}/{key}"] = np.asarray(value)
        for key, value in stage_step(pipeline, arrays).items():
            fixture[f"{pipeline}_step/{key}"] = np.asarray(value)
    fixture.update(stage_chain())
    return fixture


OUT_EVAL = Path(__file__).with_name("torch_parity_eval.npz")


def kabsch_f64(src: np.ndarray, tgt: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The weighted rigid fit tgt ~= T src of ops/svd3.weighted_kabsch in
    float64: (N, 3), (N, 3), (N,) -> (3, 4)."""
    wn = (w / (np.abs(w).sum() + 1e-16))[:, None]
    cs, ct = (src * wn).sum(0), (tgt * wn).sum(0)
    u, _, vt = np.linalg.svd((src - cs).T @ ((tgt - ct) * wn))
    v = vt.T
    rot = v @ np.diag([1.0, 1.0, np.sign(np.linalg.det(v @ u.T))]) @ u.T
    return np.concatenate([rot, (ct - rot @ cs)[:, None]], axis=1)


def icp_f64(src: np.ndarray, tgt: np.ndarray, max_corr_dist: float, init: np.ndarray,
            num_iter: int = 30) -> np.ndarray:
    """ops/icp.py::icp in float64 with exact nearest neighbours (ties to the
    lower index): (B, N, 3), (B, M, 3), init (B, 3, 4) -> (B, 3, 4)."""
    out = []
    for s, t, pose in zip(src.astype(np.float64), tgt.astype(np.float64),
                          init.astype(np.float64)):
        for _ in range(num_iter):
            moved = s @ pose[:, :3].T + pose[:, 3]
            d = ((moved[:, None] - t[None]) ** 2).sum(-1)
            nn = d.argmin(-1)
            w = (d[np.arange(len(s)), nn] < max_corr_dist ** 2).astype(np.float64)
            delta = kabsch_f64(moved, t[nn], w)
            pose = np.concatenate([delta[:, :3] @ pose[:, :3],
                                   (delta[:, :3] @ pose[:, 3] + delta[:, 3])[:, None]], 1)
        out.append(pose)
    return np.stack(out)


def eval_forward(cfg, model, params, arrays):
    """JAX's eval forward (5 iterations, clip_weight) over exact pyramids."""
    import jax
    from deepsir_tpu.models import ForwardOptions
    from deepsir_tpu.models.network import PairBatch
    m = cfg.model
    pyramids = [exact_pyramid(arrays[f"points_{s}"][..., :3], m.num_knn, m.sub_sampling_ratio)
                for s in ("src", "ref")]
    batch = PairBatch(arrays["points_src"], arrays["points_ref"], *pyramids,
                      arrays["transform_gt"], mask_src=arrays["mask_src"],
                      mask_ref=arrays["mask_ref"])
    opts = ForwardOptions(num_iter=m.num_reg_iter, clip_weight=True)
    return jax.device_get(jax.jit(lambda p, b: model.apply(p, b, opts, train=False)[1])(
        params, batch))


def _restore(run: str, cfg, pipeline: str, arrays):
    """(JAX model, params) of a tracked checkpoint, every leaf loaded."""
    import jax
    from deepsir_tpu.models import ForwardOptions, Network
    from deepsir_tpu.training import device_batch
    from deepsir_tpu.utils.checkpoint import partial_restore
    model = Network(cfg.model, pipeline=pipeline)
    extra = (ForwardOptions(num_iter=1),) if pipeline == "align" else ()
    target = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0),
                                                 device_batch(cfg, a), *extra), arrays)
    target = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), target)
    params, loaded = partial_restore(str(ROOT / run / "ckpt"), target)
    assert loaded == len(jax.tree_util.tree_leaves(target)), loaded
    return model, params


def build_eval() -> Dict[str, np.ndarray]:
    """The eval fixture: for the staged align checkpoint on the checkpoint
    pairs at 1024 points (chip_smoke.checkpoint_arrays), JAX's forward over
    exact pyramids, then `pose_optimization` under each setting of
    chip_smoke.EVAL_SETTINGS (float16: the forward on the clouds rounded to
    float16) and `compute_metrics` of the refined poses as `evaluate_align`
    takes them; what the refiners read of the forward; JAX's RANSAC draws;
    JAX's finetune in float64 (x64) and `icp_f64` from the forward's final
    pose; and JAX's label and feat sweeps (`inference_label`,
    `inference_feat`) over exact pyramids on the stages fixture's pairs."""
    import tempfile
    import jax
    import jax.numpy as jnp
    from chip_smoke import EVAL_SETTINGS, checkpoint_arrays
    from deepsir_tpu.config import replace
    from deepsir_tpu.evaluation import (finetune_pose, inference_feat, inference_label,
                                        pose_optimization)
    from deepsir_tpu.ops.gather import gather_points
    from deepsir_tpu.utils.metrics import compute_metrics
    arrays = checkpoint_arrays(dict(np.load(OUT_CKPT)), 1024)
    cfg = run_config(num_points=1024)
    model, params = _restore(CKPTS[0], cfg, "align", arrays)
    out = eval_forward(cfg, model, params, arrays)
    assert np.array_equal(out.pt_src, arrays["points_src"][..., :3])
    half = dict(arrays, **{k: arrays[k].astype(np.float16).astype(np.float32)
                           for k in ("points_src", "points_ref")})
    out16 = eval_forward(cfg, model, params, half)
    corres_dist = cfg.data.voxel_size * 2
    n = arrays["points_src"].shape[1]
    fixture = {"eval/inlier_logits": out.inlier_logits[-1],
               "eval/pred_idx": np.asarray(out.pred_idx[-1], np.uint16),
               "eval/transforms": out.transforms,
               "eval/transforms_f16": out16.transforms,
               "eval/pred_idx_f16": np.asarray(out16.pred_idx, np.uint16),
               "eval/ransac_picks": np.asarray(jax.random.randint(
                   jax.random.PRNGKey(0), (4096, 3), 0, n), np.int16)}
    for name, setting in EVAL_SETTINGS.items():
        cfg_s = replace(cfg, eval=replace(cfg.eval, **setting))
        o = out16 if setting.get("transfer_dtype") == "float16" else out
        pose = np.asarray(pose_optimization(cfg_s, arrays, o, o.transforms[-1],
                                            transforms=o.transforms))
        fixture[f"eval/{name}/pose"] = pose
        m = compute_metrics(arrays["transform_gt"], pose, arrays["points_src"],
                            arrays["points_ref"], cfg.eval.rte_thresh, cfg.eval.rre_thresh,
                            max_points=1024, mask_src=arrays["mask_src"],
                            mask_ref=arrays["mask_ref"])
        for key, value in m.items():
            fixture[f"eval/{name}/{key}"] = np.asarray(value)
    matched = np.asarray(gather_points(out.pt_ref, out.pred_idx[-1]))
    weights = np.asarray(jax.nn.sigmoid(out.inlier_logits[-1]))
    with jax.enable_x64(True):
        fixture["eval/finetune_f64"] = np.asarray(jax.vmap(
            lambda s, r, p, w: finetune_pose(s, r, p, w, corres_dist))(
            *(jnp.asarray(np.asarray(a, np.float64))
              for a in (out.pt_src, matched, out.transforms[-1], weights))))
    fixture["eval/icp_f64"] = icp_f64(arrays["points_src"][..., :3],
                                      arrays["points_ref"][..., :3], corres_dist,
                                      out.transforms[-1])

    stage_arrays = stage_pairs(1024, STAGE_PAIRS)
    for pipeline in ("label", "feat"):
        cfg_p = run_config(STAGES[pipeline], 1024)
        net, p = _restore(STAGES[pipeline], cfg_p, pipeline, stage_arrays)

        def fwd(q, a, net=net, cfg_p=cfg_p):
            return jax.device_get(net.apply(q, _exact_batch(cfg_p, a), train=False)[1])
        with tempfile.TemporaryDirectory() as tmp:
            if pipeline == "label":
                miou, iou, acc = inference_label([stage_arrays], fwd, p, cfg_p, tmp)
                fixture.update({"label/miou": np.asarray(miou), "label/iou": np.asarray(iou),
                                "label/acc": np.asarray(acc)})
            else:
                inference_feat([stage_arrays], fwd, p, cfg_p, tmp)
            names = sorted(os.listdir(tmp))
            fixture[f"{pipeline}/dump_names"] = np.asarray(names)
            fixture[f"{pipeline}/dump_shapes"] = np.asarray(
                [np.loadtxt(os.path.join(tmp, f)).shape for f in names])
    return fixture


OUT_CLI = Path(__file__).with_name("torch_parity_cli.npz")


def jax_test_run(argv):
    """JAX's test.py (align, --resume the staged checkpoint) on the flags
    `argv`, with the eval forward over exact pyramids: (the forward's
    transforms (iters, B, 3, 4), matches (iters, B, N) and `invalid` (B,) of
    every pair, pred_transforms (B, iters + 1, 3, 4), the per-iteration
    metrics of evaluate_align)."""
    import jax
    from deepsir_tpu.config import config_from_args, eval_argument_parser
    from deepsir_tpu.data.base import Loader
    from deepsir_tpu.data.datasets import get_test_dataset
    from deepsir_tpu.evaluation import evaluate_align, inference_align
    from deepsir_tpu.models import ForwardOptions
    from deepsir_tpu.models.network import PairBatch
    from deepsir_tpu.training import batch_arrays_only
    cfg = config_from_args(eval_argument_parser().parse_args(argv))
    loader = Loader(get_test_dataset(cfg), 1, shuffle=False, num_workers=4)
    model, params = _restore(CKPTS[0], cfg, "align", batch_arrays_only(next(iter(loader))))
    m = cfg.model
    opts = ForwardOptions(num_iter=m.num_reg_iter, clip_weight=True)
    apply = jax.jit(lambda p, b: model.apply(p, b, opts, train=False))
    outs = []

    def eval_step(p, arrays):
        arrays = jax.device_get(arrays)
        pyramids = [exact_pyramid(arrays[f"points_{s}"][..., :3], m.num_knn,
                                  m.sub_sampling_ratio) for s in ("src", "ref")]
        batch = PairBatch(arrays["points_src"], arrays["points_ref"], *pyramids,
                          arrays["transform_gt"], mask_src=arrays["mask_src"],
                          mask_ref=arrays["mask_ref"])
        transforms, out = apply(p, batch)
        outs.append(jax.device_get((transforms, out.pred_idx, out.invalid)))
        return transforms, out

    pred, _ = inference_align(loader, eval_step, params, cfg)
    metrics, _ = evaluate_align(pred, loader, cfg)
    transforms, idx, invalid = (np.concatenate(v, axis=min(v[0].ndim - 1, 1))
                                for v in zip(*outs[1:]))
    return transforms, idx, invalid, pred, metrics


def build_cli() -> Dict[str, np.ndarray]:
    """The CLI fixture: JAX's test.py on the tracked staged eval command
    ("staged": the forward, pred_transforms, the metrics of every
    iteration) and on each refiner command ("refiners": the forward, shared
    by the three, and each setting's refined pose and last metrics)."""
    from chip_smoke import CLI_EVAL_RUN, refiner_commands, tracked_command
    fixture = {}
    transforms, idx, invalid, pred, metrics = jax_test_run(tracked_command(CLI_EVAL_RUN))
    fixture.update({"staged/transforms": transforms, "staged/pred_idx": idx.astype(np.int16),
                    "staged/invalid": invalid, "staged/pred": pred})
    for key in metrics[0]:
        fixture[f"staged/metrics/{key}"] = np.stack([np.asarray(m[key]) for m in metrics])
    for name, argv in refiner_commands().items():
        transforms, idx, invalid, pred, metrics = jax_test_run(argv)
        if "refiners/pred_idx" in fixture:
            assert np.array_equal(fixture["refiners/pred_idx"], idx.astype(np.int16)), name
        fixture.update({"refiners/transforms": transforms,
                        "refiners/pred_idx": idx.astype(np.int16),
                        "refiners/invalid": invalid, f"refiners/{name}/pose": pred[:, -1]})
        for key, value in metrics[-1].items():
            fixture[f"refiners/{name}/{key}"] = np.asarray(value)
    return fixture


OUT_PRECISION = Path(__file__).with_name("torch_parity_precision.npz")
# XLA on the CPU drops a bf16 rounding that a convert back to fp32 follows
# ("excess precision"), in one fusion and not in its twin (a GroupNorm's
# statistics see the rounded Dense output, its normalisation the unrounded
# one). With it off every bf16 op of a jitted forward rounds, as flax's bf16
# Dense defines it op by op.
XLA_BF16 = {"xla_allow_excess_precision": False}
# the staged align checkpoint's config plus these options; "F" (fp32) is
# B16F's fp32 counterpart, "F32" the others'
PRECISION_PATHS = {"B16": dict(compute_dtype="bfloat16"),
                   "B16F": dict(compute_dtype="bfloat16", inlier_extra_feats="dist,recip",
                                clip_weight_thresh=0.05),
                   "I16": dict(inlier_compute_dtype="bfloat16"),
                   "F": dict(inlier_extra_feats="dist,recip", clip_weight_thresh=0.05),
                   "F32": {}}
DESC_ROW_STRIDE = 16      # the fixture keeps every 16th descriptor row (size)
EXTRA_ROWS_SEED = 13


def bf16_matcher(a, b):
    """The bf16 form of the correspondence search as `Network.matcher`:
    (B, N, C) x (B, M, C) -> (B, N) int32, argmin of |b|^2 - 2 bf16(a).bf16(b)
    with the norms from the fp32 inputs and fp32 sums, the lowest index on
    ties: what ops/pallas_match.py::match_argmin_single(low_precision=True)
    computes (its interpreted form is held against this in
    tests/test_torch_precision.py). JAX's CPU search ignores
    low_precision, so the bf16 fixtures pass this hook."""
    import jax
    import jax.numpy as jnp
    a, b = jax.lax.stop_gradient(a), jax.lax.stop_gradient(b)
    prod = jnp.einsum("bnc,bmc->bnm", a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    return jnp.argmin(jnp.sum(b * b, axis=-1)[:, None, :] - 2.0 * prod,
                      axis=-1).astype(jnp.int32)


def extra_rows(width: int) -> np.ndarray:
    """Two seeded rows (he-normal scale) that widen the staged checkpoint's
    inlier input layer for the `dist` and `recip` channels (B16F, F)."""
    rng = np.random.default_rng(EXTRA_ROWS_SEED)
    return (rng.normal(size=(2, width)) * np.sqrt(2.0 / 8)).astype(np.float32)


def precision_params(params, extras: bool):
    """The staged align checkpoint's params; with `extras` its inlier
    `mlp_pre` kernel (6, 8) gets extra_rows below it."""
    import copy
    params = copy.deepcopy(params)
    if extras:
        dense = params["params"]["inlier_model"]["mlp_pre"]["Dense_0"]
        dense["kernel"] = np.concatenate([np.asarray(dense["kernel"]),
                                          extra_rows(dense["kernel"].shape[1])])
    return params


def precision_config(name: str, num_points: int = 1024):
    from deepsir_tpu.config import replace
    cfg = run_config(CKPTS[0], num_points)
    return replace(cfg, model=replace(cfg.model, **PRECISION_PATHS[name]))


def precision_model(cfg):
    """JAX's align Network for `cfg`, with the bf16 search hook under bf16
    compute."""
    from deepsir_tpu.models import Network
    bf16 = cfg.model.compute_dtype == "bfloat16"
    return Network(cfg.model, pipeline="align", matcher=bf16_matcher if bf16 else None)


def precision_forward(name: str, params, arrays) -> Dict[str, np.ndarray]:
    """JAX's align forward of a PRECISION_PATHS entry over exact pyramids (5
    iterations, clip_weight): transforms, matches, `invalid`, the
    iteration-1 inlier logits, the success flags of the final pose, and the
    iteration-1 descriptors of both clouds (every DESC_ROW_STRIDE-th row)."""
    import jax
    from deepsir_tpu.math.se3 import pose_error
    from deepsir_tpu.models import ForwardOptions
    from deepsir_tpu.models.network import PairBatch
    cfg = precision_config(name, arrays["points_src"].shape[1])
    model = precision_model(cfg)
    opts = ForwardOptions(num_iter=cfg.model.num_reg_iter, clip_weight=True)
    m = cfg.model
    pyramids = [exact_pyramid(arrays[f"points_{s}"][..., :3], m.num_knn, m.sub_sampling_ratio)
                for s in ("src", "ref")]

    def descriptors(mdl, batch):
        fs, ls, fr, lr, _, _ = mdl.backbone_pair(batch, train=False)
        ss, sr = mdl.score_pair(batch, fs, fr, ls, lr)
        return (mdl.aggregate_side(batch.points_src[..., :3], fs, ss),
                mdl.aggregate_side(batch.points_ref[..., :3], fr, sr))

    def run(p, a, pyr_src, pyr_ref):
        batch = PairBatch(a["points_src"], a["points_ref"], pyr_src, pyr_ref,
                          a["transform_gt"], mask_src=a["mask_src"], mask_ref=a["mask_ref"])
        _, out = model.apply(p, batch, opts, train=False)
        return out, model.apply(p, batch, method=descriptors)

    out, (desc_src, desc_ref) = jax.device_get(
        jax.jit(run, compiler_options=XLA_BF16)(params, arrays, *pyramids))
    rre, rte = (np.asarray(e) for e in pose_error(arrays["transform_gt"], out.transforms[-1]))
    return {"transforms": np.asarray(out.transforms), "pred_idx": np.asarray(out.pred_idx, np.uint16),
            "invalid": np.asarray(out.invalid), "logits1": np.asarray(out.inlier_logits[0]),
            "succ": (rte < cfg.eval.rte_thresh) & (rre < cfg.eval.rre_thresh),
            "desc_src": np.asarray(desc_src)[:, ::DESC_ROW_STRIDE],
            "desc_ref": np.asarray(desc_ref)[:, ::DESC_ROW_STRIDE]}


def precision_step(compute: str) -> Dict[str, np.ndarray]:
    """One align training step of the staged checkpoint resumed with its
    Adam state, at dropout 0 on the train fixture's pairs over exact
    pyramids, with `compute_dtype` and `inlier_compute_dtype` both
    `compute` (bf16 with the search hook): the loss terms, `skipped`, the
    matches, the inlier grads (chip_smoke.summarize_leaf) and the dtypes of
    the params after the step."""
    import jax
    import optax
    from flax.traverse_util import flatten_dict
    from chip_smoke import summarize_leaf
    from deepsir_tpu.config import replace
    from deepsir_tpu.models import ForwardOptions
    from deepsir_tpu.models.network import PairBatch
    from deepsir_tpu.training import compute_loss, create_train_state, make_optimizer
    from deepsir_tpu.utils.checkpoint import CheckPointManager
    cfg = run_config(num_points=1024)
    cfg = replace(cfg, model=replace(cfg.model, dropout_rate=0.0, compute_dtype=compute,
                                     inlier_compute_dtype=compute))
    arrays = ckpt_pairs(1024, TRAIN_PAIRS)
    _, template = create_train_state(cfg, arrays, TRAIN_STEPS_PER_EPOCH)
    ckpt = str(ROOT / CKPTS[0] / "ckpt")
    state, _ = CheckPointManager(ckpt).load(ckpt, template)
    model = precision_model(cfg)
    m = cfg.model
    pyramids = [exact_pyramid(arrays[f"points_{s}"][..., :3], m.num_knn, m.sub_sampling_ratio)
                for s in ("src", "ref")]
    batch = PairBatch(arrays["points_src"], arrays["points_ref"], *pyramids,
                      arrays["transform_gt"], mask_src=arrays["mask_src"],
                      mask_ref=arrays["mask_ref"])
    opts = ForwardOptions(num_iter=m.num_train_reg_iter)
    rng = jax.random.PRNGKey(0)
    tx = make_optimizer(cfg, TRAIN_STEPS_PER_EPOCH)

    def step(p, opt_state):
        (loss, aux), g = jax.value_and_grad(
            lambda q: compute_loss(cfg, model, q, batch, opts, True, rng), has_aux=True)(p)
        _, out = model.apply(p, batch, opts, train=True, rngs={"dropout": rng})
        updates, _ = tx.update(g, opt_state, p)
        return loss, aux, g, out.pred_idx, optax.apply_updates(p, updates)

    loss, aux, grads, pred, params = jax.device_get(
        jax.jit(step, compiler_options=XLA_BF16)(state.params, state.opt_state))
    ok = (np.isfinite(loss) and not aux["invalid"]
          and all(np.isfinite(g).all() for g in jax.tree_util.tree_leaves(grads)))
    fixture = {"loss": np.asarray(loss), "skipped": np.asarray(not ok),
               "pred_idx": np.asarray(pred, np.uint16)}
    for key, value in aux["losses"].items():
        fixture[f"term/{key}"] = np.asarray(value)
    for path, leaf in flatten_dict(grads["params"]["inlier_model"]).items():
        for field, value in summarize_leaf(np.asarray(leaf)).items():
            fixture[f"grad/inlier_model/{'/'.join(path)}/{field}"] = value
    fixture["params_dtypes"] = np.asarray(sorted({str(np.asarray(a).dtype) for a in
                                                  jax.tree_util.tree_leaves(params)}))
    return fixture


def build_precision() -> Dict[str, np.ndarray]:
    """The precision fixture's arrays: the checkpoint fixture's 8 pairs at
    1024 points (read back from OUT_CKPT) under each PRECISION_PATHS entry
    (`<path>/...`), the extra inlier rows of B16F and F, and the align step
    in bf16 (`step_bf16/...`) and in fp32 (`step_f32/...`)."""
    from chip_smoke import checkpoint_arrays
    arrays = checkpoint_arrays(dict(np.load(OUT_CKPT)), 1024)
    params = align_params(arrays)
    fixture = {"extra_rows": extra_rows(8), "desc_row_stride": np.asarray(DESC_ROW_STRIDE)}
    for name, options in PRECISION_PATHS.items():
        p = precision_params(params, "dist" in options.get("inlier_extra_feats", ""))
        out = precision_forward(name, p, arrays)
        if name in ("F", "F32"):          # the fp32 counterparts: what the gaps need
            keep = ("logits1", "transforms", "pred_idx") + (("desc_src", "desc_ref")
                                                            if name == "F32" else ())
            out = {k: out[k] for k in keep}
        elif name != "B16":               # B16's descriptors are B16F's, F32's I16's
            del out["desc_src"], out["desc_ref"]
        for key, value in out.items():
            fixture[f"{name}/{key}"] = value
    for compute, prefix in (("bfloat16", "step_bf16"), ("float32", "step_f32")):
        for key, value in precision_step(compute).items():
            fixture[f"{prefix}/{key}"] = value
    return fixture


OUT_PARALLEL = Path(__file__).with_name("torch_parity_parallel.npz")
MODEL_PARALLEL = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4),
                      d_out=(8, 16), out_feat_dim=16, num_train_reg_iter=2, num_reg_iter=2,
                      dropout_rate=0.0)
TRAIN_PARALLEL = dict(lr=1e-3, lr_decay_epoch=1, lr_decay_ratio=0.5, lr_clip=3e-4)
PARALLEL_PAIRS = 4
PARALLEL_SEED = 3                 # init_params
# case -> (pipeline, ModelConfig options)
PARALLEL_TRAIN = {"align": ("align", {}), "label": ("label", dict(fc_norm="batch")),
                  "feat": ("feat", {})}
PARALLEL_EVAL = {"default": {}, "mutual": dict(mutual_check=True, mutual_check_tol=0.5)}
# the share of each pair's labels set to 0 (ignored), so that the semantic
# loss's weights differ from pair to pair
PARALLEL_IGNORED = (0.1, 0.3, 0.5, 0.7)


def parallel_arrays() -> Dict[str, np.ndarray]:
    """PARALLEL_PAIRS synthetic training pairs at 256 points with their
    labels, a share PARALLEL_IGNORED[b] of pair b's labels set to 0."""
    from deepsir_tpu.config import Config, DataConfig, ModelConfig
    from deepsir_tpu.data.base import Loader
    from deepsir_tpu.data.synthetic import SyntheticPairs
    from deepsir_tpu.training import batch_arrays_only
    cfg = Config(pipeline="label", model=ModelConfig(**MODEL_PARALLEL),
                 data=DataConfig(dataset_type="Synthetic")).resolved()
    ds = SyntheticPairs(cfg, "train", size=PARALLEL_PAIRS)
    batch = batch_arrays_only(next(iter(Loader(ds, batch_size=PARALLEL_PAIRS, shuffle=False,
                                               num_workers=1))))
    arrays = {k: batch[k] for k in ("points_src", "points_ref", "transform_gt",
                                    "labels_src", "labels_ref")}
    rng = np.random.default_rng(5)
    for key in ("labels_src", "labels_ref"):
        labels = arrays[key].copy()
        for b, share in enumerate(PARALLEL_IGNORED):
            labels[b][rng.random(labels.shape[1]) < share] = 0
        arrays[key] = labels
    return arrays


def _exact_pyramid_arrays(arrays) -> Dict[str, np.ndarray]:
    """Both clouds' exact_pyramid as `pyr_<side>_<field>_<level>` arrays
    (batch-leading, so that a mesh shards them with the batch)."""
    m = MODEL_PARALLEL
    out = {}
    for side in ("src", "ref"):
        pyr = exact_pyramid(arrays[f"points_{side}"][..., :3], m["num_knn"],
                            m["sub_sampling_ratio"])
        for field, levels in pyr._asdict().items():
            for lvl, a in enumerate(levels):
                out[f"pyr_{side}_{field}_{lvl}"] = a
    return out


def _pyramid_batch(cfg, arrays):
    """deepsir_tpu.training.device_batch over the pyramids in `arrays`
    (`_exact_pyramid_arrays`): JAX's CPU KNN orders near ties by the norm
    expansion, so the steps run on exact pyramids, as the other fixtures'
    do."""
    from deepsir_tpu.models.network import PairBatch
    from deepsir_tpu.ops.pyramid import Pyramid
    levels = len(cfg.model.d_out)

    def pyramid(side):
        return Pyramid(*(tuple(arrays[f"pyr_{side}_{f}_{lvl}"] for lvl in range(levels))
                         for f in Pyramid._fields))
    return PairBatch(points_src=arrays["points_src"], points_ref=arrays["points_ref"],
                     pyramid_src=pyramid("src"), pyramid_ref=pyramid("ref"),
                     transform_gt=arrays["transform_gt"],
                     labels_src=arrays.get("labels_src"), labels_ref=arrays.get("labels_ref"))


def _parallel_config(pipeline: str, **model):
    from deepsir_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    return Config(pipeline=pipeline, model=ModelConfig(**dict(MODEL_PARALLEL, **model)),
                  data=DataConfig(dataset_type="Synthetic"),
                  train=TrainConfig(**TRAIN_PARALLEL)).resolved()


def build_parallel() -> Dict[str, np.ndarray]:
    """The parallel fixture's arrays: the pairs and their exact pyramids
    (`pyr_<side>_<field>_<level>`, which the JAX steps run on); per train
    case `train/<case>/...` the loss, its terms or accuracy, `skipped` and
    the trained parameters after the step, by the port's parameter names;
    per eval case `eval/<case>/transforms` and `/pred_idx`."""
    import jax
    import jax.numpy as jnp
    import deepsir_tpu.training as jt
    from deepsir_tpu.models import Network
    from deepsir_tpu.parallel import (make_mesh, make_sharded_eval_step,
                                      make_sharded_train_step, shard_batch)
    from deepsir_tpu_torch.config import ModelConfig as PortModelConfig
    from deepsir_tpu_torch.models.network import Network as PortNetwork
    from deepsir_tpu_torch.utils.params import (from_jax_params, init_params, to_jax_params,
                                                trainable_parameters)
    assert jax.device_count() >= 4, "run with XLA_FLAGS=--xla_force_host_platform_device_count=8"
    arrays = parallel_arrays()
    feed = dict(arrays, **_exact_pyramid_arrays(arrays))
    fixture = dict(feed, thres_radius=np.asarray(_parallel_config("align").loss.thres_radius))
    real = jt.device_batch
    jt.device_batch = _pyramid_batch
    try:
        mesh = make_mesh(num_data=4, num_model=1, devices=jax.devices()[:4])
        for case, (pipeline, options) in PARALLEL_TRAIN.items():
            cfg = _parallel_config(pipeline, **options)
            port = PortNetwork(PortModelConfig(**dict(MODEL_PARALLEL, **options)), pipeline)
            params = to_jax_params(init_params(port.cfg, seed=PARALLEL_SEED, pipeline=pipeline))
            model = Network(cfg.model, pipeline=pipeline)
            tx = jt.make_optimizer(cfg, 1)
            state = jt.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
            step = make_sharded_train_step(cfg, model, tx, mesh)
            state, aux = jax.device_get(step(state, shard_batch(mesh, feed),
                                             jax.random.PRNGKey(0)))
            fixture[f"train/{case}/loss"] = np.asarray(aux["loss"])
            fixture[f"train/{case}/skipped"] = np.asarray(aux["skipped"])
            if "acc" in aux:
                fixture[f"train/{case}/acc"] = np.asarray(aux["acc"])
            for key, value in aux.get("losses", {}).items():
                fixture[f"train/{case}/losses/{key}"] = np.asarray(value)
            after = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params), port)
            for name, _ in trainable_parameters(port):
                fixture[f"train/{case}/param/{name}"] = after[name].numpy()
        mesh = make_mesh(num_data=2, num_model=2, devices=jax.devices()[:4])
        for case, options in PARALLEL_EVAL.items():
            cfg = _parallel_config("align", **options)
            params = to_jax_params(init_params(PortModelConfig(**dict(MODEL_PARALLEL, **options)),
                                               seed=PARALLEL_SEED))
            step = make_sharded_eval_step(cfg, Network(cfg.model, pipeline="align"), mesh,
                                          num_iter=MODEL_PARALLEL["num_reg_iter"])
            transforms, out = jax.device_get(step(params, shard_batch(mesh, feed)))
            fixture[f"eval/{case}/transforms"] = np.asarray(transforms)
            fixture[f"eval/{case}/pred_idx"] = np.asarray(out.pred_idx)
    finally:
        jt.device_batch = real
    return fixture


def main(names=("small", "paths", "ckpt", "train", "stages", "eval", "cli")) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    makers = {"small": (OUT, build), "paths": (OUT_PATHS, build_paths),
              "ckpt": (OUT_CKPT, build_ckpt), "train": (OUT_TRAIN, build_train),
              "stages": (OUT_STAGES, build_stages), "eval": (OUT_EVAL, build_eval),
              "cli": (OUT_CLI, build_cli), "precision": (OUT_PRECISION, build_precision),
              "parallel": (OUT_PARALLEL, build_parallel)}
    for name in names:
        out, make = makers[name]
        np.savez_compressed(out, **make())
        print(f"wrote {out} ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    if "parallel" in sys.argv[1:]:
        # the JAX mesh needs virtual devices, set before JAX starts
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    main(sys.argv[1:] or ("small", "paths", "ckpt", "train", "stages", "eval", "cli"))
