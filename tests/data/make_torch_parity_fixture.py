"""Write tests/data/torch_parity_small.npz: the JAX package's align forward on
a tiny config, for holding the PyTorch port against it where JAX is absent.

Run on the CPU with JAX installed:
    python tests/data/make_torch_parity_fixture.py

The file holds the model config (`model_json`), the flax params
(`param/<path>`), the input arrays, both clouds' pyramid indices and the
forward's outputs. tests/test_torch_align.py
regenerates it in memory and fails when the committed file differs.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

OUT = Path(__file__).with_name("torch_parity_small.npz")
MODEL = dict(feat_len=3, num_points=1024, num_knn=8, sub_sampling_ratio=(4, 4),
             d_out=(8, 16), out_feat_dim=16, num_classes=5, num_reg_iter=2)
BATCH = 2
SEED = 0


def make_arrays(seed: int = SEED) -> Dict[str, np.ndarray]:
    """src: unit-normal clouds; ref: each src cloud rotated ~10 deg about a
    random axis, shifted, jittered and reshuffled."""
    rng = np.random.default_rng(seed)
    n = MODEL["num_points"]
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
    return {"points_src": src, "points_ref": ref,
            "transform_gt": np.tile(np.eye(3, 4, dtype=np.float32), (BATCH, 1, 1))}


def _setup():
    from deepsir_tpu.config import Config, ModelConfig
    from deepsir_tpu.models import ForwardOptions, Network
    cfg = Config(pipeline="align", model=ModelConfig(**MODEL))
    model = Network(cfg.model, pipeline="align")
    opts = ForwardOptions(num_iter=MODEL["num_reg_iter"], clip_weight=True)
    return cfg, model, opts


def build(seed: int = SEED) -> Dict[str, np.ndarray]:
    """Run JAX on the CPU; returns the fixture's arrays."""
    import jax
    from deepsir_tpu.training import device_batch
    cfg, model, opts = _setup()
    arrays = make_arrays(seed)
    params = jax.jit(lambda r, a: model.init(r, device_batch(cfg, a), opts))(
        jax.random.PRNGKey(seed), arrays)

    @jax.jit
    def fwd(p, a):
        batch = device_batch(cfg, a)
        _, out = model.apply(p, batch, opts, train=False)
        return batch.pyramid_src, batch.pyramid_ref, out

    pyr_src, pyr_ref, out = jax.device_get(fwd(params, arrays))
    fixture = dict(arrays, model_json=np.asarray(json.dumps(MODEL)))
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    for path, leaf in flat:
        fixture["param/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    for side, pyr in (("src", pyr_src), ("ref", pyr_ref)):
        for lvl in range(len(MODEL["d_out"])):
            fixture[f"{side}_neigh_idx_{lvl}"] = np.asarray(pyr.neigh_idx[lvl])
            fixture[f"{side}_interp_idx_{lvl}"] = np.asarray(pyr.interp_idx[lvl])
    fixture.update(transforms=np.asarray(out.transforms),
                   pred_idx=np.asarray(out.pred_idx),
                   inlier_logits=np.asarray(out.inlier_logits),
                   invalid=np.asarray(out.invalid))
    return fixture


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(OUT, **build())
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    main()
