"""The eval harness's pose refiners (evaluation.finetune_pose,
average_poses, ops/icp.py::icp, ops/ransac.py::ransac_correspondence and
evaluation.pose_optimization) against the JAX package on the same numpy
inputs, on the CPU.

Poses are compared by chip_smoke.pose_gap: the largest rotation-entry
difference, and the largest translation difference in units of the
clouds' radius (a float32 solve over clouds of radius r carries
translation errors of order r * 1e-6).

Tolerances and why:
- finetune_pose: 1e-5 against JAX's float64 (x64) run (measured 7e-8);
  against JAX's float32 run FINETUNE_F32 (measured 1.2e-7: 200 Adam steps,
  each rounding on both sides); in float64, the port's first 1-3 updates
  against optax's on the port's own gradients 1e-8 (optax's float32 bias
  corrections), which holds the update's form (bias corrections, eps
  outside the square root, lr 0.1 * 0.999^t).
- icp: 1e-5 against the float64 numpy ICP with exact neighbours of the
  fixture script (`icp_f64`); the port in float64 against it 1e-10 (the
  same algorithm; the float32 port measured 4.5e-6). Against JAX's float32
  ICP ICP_F32 (measured 4.1e-6): JAX ranks neighbours by the norm
  expansion, the port by direct differences, and the distance gate may
  flip at its border.
- ransac_correspondence with JAX's draws: 1e-5, the inlier fraction within
  an ulp (XLA's float32 division on the CPU is not always correctly
  rounded).
- average_poses: 1e-6 (numpy's and torch's SVD).
- pose_optimization on one JAX forward's outputs (the small parity
  fixture), under each refiner setting: 1e-5 (measured 3e-7); settings with
  ICP ICP_F32 (measured 4.6e-6).
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import chip_smoke
from deepsir_tpu import evaluation as jax_evaluation
from deepsir_tpu.config import Config, ModelConfig as JaxModelConfig, replace as jax_replace
from deepsir_tpu.math import se3_np as jax_se3_np
from deepsir_tpu.ops.icp import icp as jax_icp
from deepsir_tpu.ops.ransac import ransac_correspondence as jax_ransac
from deepsir_tpu_torch.config import (DataConfig, EvalConfig, LossConfig, ModelConfig, RunConfig,
                                      TrainConfig, replace)
from deepsir_tpu_torch.evaluation import average_poses, finetune_pose, pose_optimization
from deepsir_tpu_torch.models.network import AlignOutput
from deepsir_tpu_torch.ops.icp import icp
from deepsir_tpu_torch.ops.ransac import ransac_correspondence

_spec = importlib.util.spec_from_file_location(
    "make_torch_parity_fixture",
    Path(__file__).parent / "data" / "make_torch_parity_fixture.py")
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)

FINETUNE_F32 = 2e-6
ICP_F32 = 2e-5
DIST = 0.6                         # twice the default voxel size


def random_poses(rng, b, max_deg=40.0, min_deg=0.0, trans=2.0):
    """(B, 3, 4) float32 poses rotated by min_deg..max_deg about random axes."""
    axes = rng.normal(size=(b, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ang = np.deg2rad(rng.uniform(min_deg, max_deg, size=(b, 1)))
    out = np.zeros((b, 3, 4), np.float32)
    out[:, :, :3] = Rotation.from_rotvec(axes * ang).as_matrix()
    out[:, :, 3] = rng.uniform(-trans, trans, size=(b, 3))
    return out


def compose(a, b):
    """a @ b of (B, 3, 4) poses, as float32."""
    return jax_se3_np.concatenate(a, b).astype(np.float32)


def gap(got, want, radius):
    return float(chip_smoke.pose_gap(np.asarray(got), np.asarray(want), radius).max())


def t32(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


@pytest.fixture(scope="module")
def problem():
    """Two rigid pairs of 600 points (radius ~10): the target is the moved
    source with 0.01 noise, reshuffled; matches with 30% outliers and
    weights; initial poses 3-6 deg and ~0.3 off the truth."""
    rng = np.random.default_rng(7)
    b, n = 2, 600
    src = (rng.normal(size=(b, n, 3)) * 3).astype(np.float32)
    gt = random_poses(rng, b, max_deg=30.0)
    moved = (src @ np.swapaxes(gt[:, :, :3], 1, 2) + gt[:, None, :, 3]
             + rng.normal(scale=0.01, size=(b, n, 3))).astype(np.float32)
    matched = moved.copy()
    out = rng.uniform(size=(b, n)) < 0.3
    matched[out] = (rng.normal(size=(int(out.sum()), 3)) * 3).astype(np.float32)
    tgt = np.stack([m[rng.permutation(n)] for m in moved])
    init = compose(random_poses(rng, b, max_deg=6.0, min_deg=3.0, trans=0.3), gt)
    weights = rng.uniform(0.1, 1.0, size=(b, n)).astype(np.float32)
    radius = np.abs(src).max(axis=(1, 2))
    return dict(src=src, tgt=tgt, matched=matched, init=init, weights=weights, gt=gt,
                radius=radius)


def jax_finetune(p, x64: bool, max_iter: int = 200):
    dtype = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        args = [jnp.asarray(np.asarray(p[k], dtype)) for k in ("src", "matched", "init",
                                                              "weights")]
        return np.asarray(jax.vmap(lambda s, r, q, w: jax_evaluation.finetune_pose(
            s, r, q, w, DIST, max_iter=max_iter))(*args))


def test_finetune_pose_against_jax(problem):
    p = problem
    got = finetune_pose(t32(p["src"]), t32(p["matched"]), t32(p["init"]), t32(p["weights"]),
                        DIST).numpy()
    assert gap(got, jax_finetune(p, x64=True), p["radius"]) <= 1e-5, "vs JAX float64"
    assert gap(got, jax_finetune(p, x64=False), p["radius"]) <= FINETUNE_F32, "vs JAX float32"
    # it refines: closer to the truth than where it started
    assert np.abs(got - p["gt"]).max() < 0.5 * np.abs(p["init"] - p["gt"]).max()


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_finetune_pose_steps_match_optax(problem, steps):
    """On one pair in float64, the port's first `steps` updates equal
    optax's chain (scale_by_adam, then exponential_decay(0.1, 1, 0.999),
    then -1) applied to the port's own gradients: the bias corrections, eps
    outside the square root and the schedule, step by step. (Fed JAX's
    gradients instead, a gradient entry near Adam's eps turns its rounding
    into a visible step.) optax computes its bias corrections in float32
    even under x64, 1.5e-8 relative: ~1.5e-9 per step here. A misplaced
    eps or a missing bias correction moves a step by 1e-7 or more."""
    import optax
    from deepsir_tpu_torch.evaluation import _rot6d_to_matrix, _smooth_l1
    src, matched, init, weights = (torch.from_numpy(np.asarray(problem[k][:1], np.float64))
                                   for k in ("src", "matched", "init", "weights"))
    got = finetune_pose(src, matched, init, weights, DIST, max_iter=steps)[0].numpy()

    def grads(p):
        r = torch.from_numpy(np.asarray(p["rot6d"])).requires_grad_(True)
        t = torch.from_numpy(np.asarray(p["trans"])).requires_grad_(True)
        moved = src[0] @ _rot6d_to_matrix(r).T + t
        _smooth_l1(moved, matched[0], weights[0], DIST).backward()
        return {"rot6d": jnp.asarray(r.grad.numpy()), "trans": jnp.asarray(t.grad.numpy())}

    with jax.enable_x64(True):
        tx = optax.chain(optax.scale_by_adam(),
                         optax.scale_by_schedule(optax.exponential_decay(0.1, 1, 0.999)),
                         optax.scale(-1.0))
        pose = init[0].numpy()
        params = {"rot6d": jnp.asarray(np.concatenate([pose[:, 0], pose[:, 1]])),
                  "trans": jnp.asarray(pose[:, 3])}
        state = tx.init(params)
        for _ in range(steps):
            updates, state = tx.update(grads(params), state)
            params = optax.apply_updates(params, updates)
        rot = _rot6d_to_matrix(torch.from_numpy(np.asarray(params["rot6d"]))).numpy()
        want = np.concatenate([rot, np.asarray(params["trans"])[:, None]], axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_average_poses(rng):
    base = random_poses(rng, 4)
    stack = np.stack([compose(random_poses(rng, 4, max_deg=2.0, trans=0.05), base)
                      for _ in range(3)])
    got = average_poses(torch.from_numpy(stack)).numpy()
    want = jax_evaluation.average_poses(stack)
    np.testing.assert_allclose(got, want, atol=1e-6)
    rot = got[:, :, :3]
    np.testing.assert_allclose(rot @ np.swapaxes(rot, 1, 2), np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-6)


def test_icp_against_float64_and_jax(problem):
    p = problem
    got = icp(t32(p["src"]), t32(p["tgt"]), DIST, init=t32(p["init"])).numpy()
    ref64 = F.icp_f64(p["src"], p["tgt"], DIST, p["init"])
    assert gap(got, ref64, p["radius"]) <= 1e-5, "vs the float64 numpy ICP"
    got64 = icp(*(torch.from_numpy(np.asarray(p[k], np.float64)) for k in ("src", "tgt")),
                DIST, init=torch.from_numpy(p["init"].astype(np.float64))).numpy()
    assert gap(got64, ref64, p["radius"]) <= 1e-10, "port in float64 vs the float64 ICP"
    want = np.asarray(jax.vmap(lambda s, t, q: jax_icp(s, t, DIST, init=q, num_iter=30))(
        jnp.asarray(p["src"]), jnp.asarray(p["tgt"]), jnp.asarray(p["init"])))
    assert gap(got, want, p["radius"]) <= ICP_F32, "vs JAX float32"
    assert np.abs(got - p["gt"]).max() < 0.05


def test_ransac_with_jax_draws(problem):
    p = problem
    n = p["src"].shape[1]
    corres = np.stack([np.arange(n), np.arange(n)], -1).astype(np.int32)
    picks = np.array(jax.random.randint(jax.random.PRNGKey(0), (4096, 3), 0, n))
    for b in range(len(p["src"])):
        want, want_frac = jax_ransac(jax.random.PRNGKey(0), jnp.asarray(p["src"][b]),
                                     jnp.asarray(p["matched"][b]), jnp.asarray(corres), DIST)
        got, frac = ransac_correspondence(t32(p["src"][b]), t32(p["matched"][b]),
                                          torch.from_numpy(corres).long(), DIST,
                                          picks=torch.from_numpy(picks))
        assert gap(got[None].numpy(), np.asarray(want)[None], p["radius"][b:b + 1]) <= 1e-5
        # XLA's float32 division is not always correctly rounded: 1 ulp
        np.testing.assert_allclose(float(frac), float(want_frac), rtol=2.4e-7)


def test_ransac_draws_from_the_generator(problem):
    p = problem
    n = p["src"].shape[1]
    corres = torch.stack([torch.arange(n), torch.arange(n)], -1)
    runs = [ransac_correspondence(t32(p["src"][0]), t32(p["matched"][0]), corres, DIST,
                                  num_hypotheses=512,
                                  generator=torch.Generator().manual_seed(seed))[0]
            for seed in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    for r in runs:
        assert np.abs(r.numpy() - p["gt"][0]).max() < 0.1


@pytest.fixture(scope="module")
def forward():
    """The JAX forward stored in tests/data/torch_parity_small.npz (a small
    random model, 2 pairs of 1024 points, 2 iterations): (host arrays, what
    the refiners read of its AlignOutput as numpy, the same as the port's
    AlignOutput)."""
    fx = dict(np.load(F.OUT))
    arrays = {k: fx[k] for k in ("points_src", "points_ref", "transform_gt")}
    fields = dict(transforms=fx["transforms"], inlier_logits=fx["inlier_logits"],
                  pred_idx=fx["pred_idx"].astype(np.int64), invalid=fx["invalid"],
                  pt_src=fx["points_src"][..., :3], pt_ref=fx["points_ref"][..., :3],
                  score_src=np.zeros(fx["points_src"].shape[:2], np.float32),
                  score_ref=np.zeros(fx["points_ref"].shape[:2], np.float32))
    out = SimpleNamespace(**fields)
    port = AlignOutput(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()})
    return arrays, out, port


@pytest.mark.parametrize("name", [k for k in chip_smoke.EVAL_SETTINGS if k != "float16"])
def test_pose_optimization(forward, name):
    arrays, out, port = forward
    setting = chip_smoke.EVAL_SETTINGS[name]
    cfg = Config(pipeline="align", model=JaxModelConfig(**F.MODEL))
    want = np.asarray(jax_evaluation.pose_optimization(
        jax_replace(cfg, eval=jax_replace(cfg.eval, **setting)), arrays, out,
        out.transforms[-1], transforms=out.transforms))
    cfgs = RunConfig(ModelConfig(**F.MODEL), LossConfig(), TrainConfig(), "align",
                     replace(EvalConfig(), **setting),
                     DataConfig(voxel_size=cfg.data.voxel_size))
    n = out.pred_idx.shape[-1]
    picks = torch.from_numpy(np.array(jax.random.randint(jax.random.PRNGKey(0), (4096, 3),
                                                           0, n)))
    got = pose_optimization(cfgs, arrays, port, port.transforms[-1],
                            transforms=port.transforms, ransac_picks=picks).numpy()
    radius = np.abs(arrays["points_src"][..., :3]).max(axis=(1, 2))
    tol = ICP_F32 if setting.get("use_icp") else 1e-5
    assert gap(got, want, radius) <= tol
    if not setting:
        np.testing.assert_array_equal(got, out.transforms[-1])
