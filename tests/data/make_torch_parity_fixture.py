"""Write the JAX package's align forward on tiny configs, for holding the
PyTorch port against it where JAX is absent:
- tests/data/torch_parity_small.npz: the default options (MODEL);
- tests/data/torch_parity_paths.npz: the `dist,recip` inlier channels, the
  relaxed mutual gate and the Morton pyramid with windowed KNN
  (MODEL_PATHS), at 4096 points so that level 0 is really windowed; its
  clouds are Morton-sorted before the forward and its index arrays stored
  as uint16 to keep the file small.

Run on the CPU with JAX installed:
    python tests/data/make_torch_parity_fixture.py

Each file holds the model config (`model_json`), the flax params
(`param/<path>`), the input arrays, both clouds' pyramid indices and the
forward's outputs. tests/test_torch_align.py and
tests/test_torch_align_paths.py regenerate them in memory and fail when a
committed file differs.
"""
from __future__ import annotations

import json
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


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    for out, fixture in ((OUT, build()), (OUT_PATHS, build_paths())):
        np.savez_compressed(out, **fixture)
        print(f"wrote {out} ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    main()
