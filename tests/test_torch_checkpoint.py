"""Trained weights through the port on the CPU: the two tracked align
checkpoints, read by the port's own decoder (utils/checkpoint.py), against
the JAX forward stored in tests/data/torch_parity_ckpt.npz; and the port's
`pose_error` against JAX's.

The fixture's JAX forward runs over exact pyramids (float64 KNN), which the
port's pyramids must equal index for index; its success flags are those of
JAX's eval forward.

Tolerances: iteration-1 correspondences >= 99.5% equal; `invalid` and the
success flags (RRE < 5 deg and RTE < 0.6, the runs' eval block) equal;
transforms 1e-4 (the CPU bound of the parity tests) for each pair up to the
first iteration whose matches differ from JAX's (a flipped match changes the
solve's input) or whose pose solve is ill-conditioned (chip_smoke.py's
`held_iterations`: fp32 rounding alone moves such a solve by up to ~1e-3).
"""
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from deepsir_tpu.math import se3 as jax_se3
from deepsir_tpu_torch.config import from_run_config
from deepsir_tpu_torch.math import se3
from deepsir_tpu_torch.models.network import ForwardOptions, Network
from deepsir_tpu_torch.training import device_batch
from deepsir_tpu_torch.utils.checkpoint import load_checkpoint, read_params
from deepsir_tpu_torch.utils.params import flax_path, from_jax_params

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = Path(__file__).parent / "data" / "param_manifest_align.json"
_spec = importlib.util.spec_from_file_location(
    "make_torch_parity_fixture",
    Path(__file__).parent / "data" / "make_torch_parity_fixture.py")
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(F.OUT_CKPT))


@pytest.mark.parametrize("ckpt", F.CKPTS)
def test_every_manifest_leaf_arrives(ckpt):
    cfg = from_run_config(ROOT / ckpt)
    net = Network(cfg)
    state = from_jax_params(read_params(ROOT / ckpt / "ckpt"), net)
    manifest = json.loads(MANIFEST.read_text())
    arrived = {}
    for key, value in state.items():
        path, transpose = flax_path(key)
        arrived["params/" + "/".join(path)] = list(value.T.shape if transpose else value.shape)
    assert arrived == manifest
    assert len(state) == 340 and sum(v.numel() for v in state.values()) == 2_746_668


def test_fixture_pairs_are_the_runs_synthetic_pairs(fixture):
    assert list(fixture["checkpoints"]) == list(F.CKPTS)
    for n, pairs in F.CKPT_PAIRS:
        fresh = F.ckpt_pairs(n, pairs)
        stored = chip_smoke.checkpoint_arrays(fixture, n)
        assert sorted(fresh) == sorted(stored)
        for key, want in fresh.items():
            np.testing.assert_array_equal(stored[key], want, err_msg=f"{n} {key}")
    assert F.OUT_CKPT.stat().st_size < 1 << 20


@pytest.fixture(scope="module")
def port_runs(fixture):
    """Checkpoint index -> (the port's AlignOutput, RRE, RTE, the solves'
    conditioning, its batch) on the 1024-point pairs."""
    runs = {}
    arrays = chip_smoke.checkpoint_arrays(fixture, 1024)
    for i, ckpt in enumerate(F.CKPTS):
        cfg = from_run_config(ROOT / ckpt)
        net = load_checkpoint(cfg, ROOT / ckpt / "ckpt", device="cpu")
        batch = device_batch(cfg, arrays, device="cpu")
        out = net.forward_align(batch, ForwardOptions(num_iter=cfg.num_reg_iter,
                                                      clip_weight=True))
        rre, rte = se3.pose_error(torch.from_numpy(arrays["transform_gt"]), out.transforms[-1])
        cond = chip_smoke.solve_conditioning(torch, out, out.pt_src, out.pt_ref, cfg,
                                             batch.mask_src)
        runs[i] = out, rre.numpy(), rte.numpy(), cond.numpy(), batch
    return runs


def test_pyramids_are_exact(fixture, port_runs):
    """The port's pyramids equal the exact float64 pyramids JAX ran over."""
    arrays = chip_smoke.checkpoint_arrays(fixture, 1024)
    batch = port_runs[0][4]
    for side in ("src", "ref"):
        want = F.exact_pyramid(arrays[f"points_{side}"][..., :3], 16, (4, 4, 4, 4))
        got = getattr(batch, f"pyramid_{side}")
        for field in ("neigh_idx", "pool_idx", "interp_idx"):
            for lvl, (g, w) in enumerate(zip(getattr(got, field), getattr(want, field))):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{side} {field}[{lvl}]")


@pytest.mark.parametrize("index", range(len(F.CKPTS)))
def test_checkpoint_reproduces_jax(fixture, port_runs, index):
    out, rre, rte, cond, _ = port_runs[index]
    run = json.loads((ROOT / F.CKPTS[index] / "config.json").read_text())
    want = {k[len(f"ckpt{index}_"):]: v for k, v in fixture.items()
            if k.startswith(f"ckpt{index}_")}
    want_idx = want["pred_idx"].astype(np.int64)
    assert (out.pred_idx[0].numpy() == want_idx[0]).mean() >= 0.995
    np.testing.assert_array_equal(out.invalid.numpy(), want["invalid"])
    succ = (rte < run["eval"]["rte_thresh"]) & (rre < run["eval"]["rre_thresh"])
    np.testing.assert_array_equal(succ, want["succ"])
    assert succ.any() and not succ.all()        # both outcomes are held
    held = chip_smoke.held_iterations(out.pred_idx.numpy(), want_idx, cond)
    assert (held == out.transforms.shape[0]).sum() >= 5     # most pairs are held throughout
    for b, n in enumerate(held):
        np.testing.assert_allclose(out.transforms.numpy()[:n, b], want["transforms"][:n, b],
                                   atol=1e-4, err_msg=f"pair {b}, {n} iterations held")


def _random_poses(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                    2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                    2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                   axis=1).reshape(n, 3, 3)
    return np.concatenate([rot, rng.normal(size=(n, 3, 1))], axis=2).astype(np.float32)


def test_pose_error_matches_jax():
    rng = np.random.default_rng(0)
    gt = _random_poses(rng, 64)
    pred = np.concatenate([_random_poses(rng, 60), gt[60:62],          # equal: zero error
                           np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))])
    pred[63, :, :3] = np.diag([1.0, -1.0, -1.0])                      # 180 deg about x
    gt[63] = np.eye(3, 4)
    want_r, want_t = (np.array(e) for e in jax_se3.pose_error(jnp.asarray(gt),
                                                                 jnp.asarray(pred)))
    got_r, got_t = (e.numpy() for e in se3.pose_error(torch.from_numpy(gt),
                                                       torch.from_numpy(pred)))
    # at zero error the arccos resolves one fp32 step of the cosine, 0.028 deg
    zero = slice(60, 62)
    assert (got_r[zero] < 0.03).all() and (want_r[zero] < 0.03).all()
    got_r[zero] = want_r[zero] = 0.0
    np.testing.assert_allclose(got_r, want_r, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got_r).all() and abs(got_r[63] - 180.0) < 1e-3


@pytest.mark.parametrize("name", list(chip_smoke.PATHS))
def test_chip_smoke_launch_counts_follow_the_geometry(name):
    """Each path's stated launches per batch are what the window geometry and
    the refine subset give (R: 16 + 8 K1 launches, the subset's pyramid
    searching 4500, 1125, 281 and 70 points), and its bf16-form K2/K3
    launches what its compute dtype gives (B16, B16F: all of them)."""
    _, stride, per_batch, bf16_per_batch = chip_smoke.PATHS[name]
    cfg = chip_smoke.path_config(name)
    assert tuple(chip_smoke.expected_launches(cfg, stride).values()) == per_batch
    assert tuple(chip_smoke.expected_bf16_launches(cfg, stride).values()) == bf16_per_batch
