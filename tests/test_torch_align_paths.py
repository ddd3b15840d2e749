"""The port's align inference forward along the flagship and Morton paths,
end to end (`device_batch` -> `Network.forward_align`), against fresh JAX
runs with the same params and inputs, on the CPU; and the committed
tests/data/torch_parity_paths.npz against a fresh run.

Cases, at the fixture's narrow width:
- F: `inlier_extra_feats="dist,recip"`, `clip_weight_thresh=0.05` (the
  round-4 flagship), and the same with the names in the other order;
- F+gate: F with `mutual_check`, at tol 0 (exact reciprocity) and 0.6, and
  the gate without extra channels;
- M: `pyramid_order="morton"`, `knn_window_halo=1`, at 4096 points so that
  level 0 is really windowed (at 1024 points 2 value blocks < width 3);
- the paths fixture's config: all of the above at once.

Tolerances and why:
- pyramid indices: equal but for near ties, at most 0.1% of entries, each
  within 1e-5 relative in float64 distance (JAX ranks by the norm
  expansion, the port by direct subtraction; at 4096 points a few
  neighbour pairs swap).
- descriptors: 1e-4 (float32 in another summation order through ~40 layers).
- iteration-1 pred_idx, and the reverse match ridx of the same descriptors:
  >= 99.5% of rows agree (descriptor near ties may pick another point).
- transforms and inlier logits: 1e-4 for the pairs whose pred_idx agrees in
  every iteration (a flipped match changes the solve's input); transforms
  1e-3 for every pair, the bound chip_smoke.py holds on the card.
- invalid: equal.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deepsir_tpu.ops.distance import nearest_neighbour_bidirectional as jax_bidir
from deepsir_tpu.training import device_batch as jax_device_batch
from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.network import ForwardOptions, Network
from deepsir_tpu_torch.ops.distance import nearest_neighbour_bidirectional
from deepsir_tpu_torch.training import device_batch
from deepsir_tpu_torch.utils.params import (from_jax_params, load_network,
                                            unflatten_params)

_spec = importlib.util.spec_from_file_location(
    "make_torch_parity_fixture",
    Path(__file__).parent / "data" / "make_torch_parity_fixture.py")
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)

INPUTS = ("points_src", "points_ref", "transform_gt")
FLAGSHIP = dict(F.MODEL, inlier_extra_feats="dist,recip", clip_weight_thresh=0.05)
CASES = {
    "F": FLAGSHIP,
    "F-recip,dist": dict(FLAGSHIP, inlier_extra_feats="recip,dist"),
    "F+gate-tol0": dict(FLAGSHIP, mutual_check=True),
    "F+gate-tol0.6": dict(FLAGSHIP, mutual_check=True, mutual_check_tol=0.6),
    "gate-only": dict(F.MODEL, mutual_check=True, mutual_check_tol=0.6),
    "M": dict(F.MODEL, num_points=4096, pyramid_order="morton", knn_window_halo=1),
    "paths-fixture": F.MODEL_PATHS,
}


def _descriptors(mdl, batch):
    fs0, ls, fr0, lr, _, _ = mdl.backbone_pair(batch, train=False)
    ss, sr = mdl.score_pair(batch, fs0, fr0, ls, lr)
    return (mdl.aggregate_side(batch.points_src[..., :3], fs0, ss),
            mdl.aggregate_side(batch.points_ref[..., :3], fr0, sr))


@pytest.fixture(scope="module")
def runs():
    """Case name -> its JAX and port runs, made on first use."""
    return {}


def _run(runs, name):
    if name in runs:
        return runs[name]
    model_cfg = CASES[name]
    fx = F.build_paths() if name == "paths-fixture" else F.build(F.SEED, model_cfg)
    cfg, model, _ = F._setup(model_cfg)
    params = unflatten_params(fx)
    arrays = {k: fx[k] for k in INPUTS}
    jdesc = jax.jit(lambda p, a: model.apply(p, jax_device_batch(cfg, a),
                                             method=_descriptors))(params, arrays)
    jdesc = [np.asarray(d) for d in jdesc]

    port_cfg = ModelConfig(**model_cfg)
    state = from_jax_params(params, Network(port_cfg))
    net = load_network(port_cfg, state, device="cpu")
    batch = device_batch(port_cfg, arrays, device="cpu")
    with torch.no_grad():
        fs0, ls, fr0, lr = net.backbone_pair(batch)
        ss, sr = net.score_pair(batch, fs0, fr0, ls, lr)
        desc = (net.aggregate_side(batch.points_src[..., :3], fs0, ss),
                net.aggregate_side(batch.points_ref[..., :3], fr0, sr))
    out = net.forward_align(batch, ForwardOptions(num_iter=model_cfg["num_reg_iter"],
                                                  clip_weight=True))
    runs[name] = dict(fx=fx, jdesc=jdesc, state=state, net=net, batch=batch,
                      desc=[d.numpy() for d in desc], out=out)
    return runs[name]


def _assert_near_ties(got, want, query, cand, what):
    got = got.numpy().reshape(got.shape[0], got.shape[1], -1)
    want = np.asarray(want, np.int64).reshape(got.shape)
    bad = got != want
    assert bad.mean() <= 1e-3, what
    for b, i, j in zip(*np.nonzero(bad)):
        d_g = ((cand[b, got[b, i, j]].astype(np.float64) - query[b, i]) ** 2).sum()
        d_w = ((cand[b, want[b, i, j]].astype(np.float64) - query[b, i]) ** 2).sum()
        np.testing.assert_allclose(d_g, d_w, rtol=1e-5, atol=1e-9, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_pyramids_match(runs, name):
    run = _run(runs, name)
    fx, batch = run["fx"], run["batch"]
    strided = CASES[name].get("pyramid_order") == "morton"
    for side, pyr in (("src", batch.pyramid_src), ("ref", batch.pyramid_ref)):
        for lvl, r in enumerate(CASES[name]["sub_sampling_ratio"]):
            xyz = pyr.xyz[lvl].numpy()
            nxt = xyz[:, ::r if strided else 1][:, :xyz.shape[1] // r]
            _assert_near_ties(pyr.neigh_idx[lvl], fx[f"{side}_neigh_idx_{lvl}"], xyz, xyz,
                              f"{side} neigh_idx[{lvl}]")
            _assert_near_ties(pyr.interp_idx[lvl], fx[f"{side}_interp_idx_{lvl}"], xyz, nxt,
                              f"{side} interp_idx[{lvl}]")


@pytest.mark.parametrize("name", list(CASES))
def test_descriptors_and_reverse_match(runs, name):
    run = _run(runs, name)
    for what, got, want in zip(("desc_src", "desc_ref"), run["desc"], run["jdesc"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=what)
    idx, ridx = nearest_neighbour_bidirectional(*(torch.from_numpy(d) for d in run["desc"]))
    jidx, jridx = jax_bidir(*run["jdesc"], method="xla")
    assert (idx.numpy() == np.asarray(jidx)).mean() >= 0.995
    assert (ridx.numpy() == np.asarray(jridx)).mean() >= 0.995
    np.testing.assert_array_equal(idx.numpy(), run["out"].pred_idx[0].numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_align_outputs(runs, name):
    run = _run(runs, name)
    fx, out = run["fx"], run["out"]
    pred = out.pred_idx.numpy()
    want = fx["pred_idx"].astype(np.int64)
    assert pred.shape == want.shape
    assert (pred[0] == want[0]).mean() >= 0.995
    np.testing.assert_array_equal(out.invalid.numpy(), fx["invalid"])
    np.testing.assert_allclose(out.transforms.numpy(), fx["transforms"], atol=1e-3)
    same = (pred == want).all(axis=(0, 2))          # per pair
    np.testing.assert_allclose(out.transforms.numpy()[:, same],
                               fx["transforms"][:, same], atol=1e-4)
    np.testing.assert_allclose(out.inlier_logits.numpy()[:, same],
                               fx["inlier_logits"][:, same], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["F", "gate-only", "M"])
def test_every_leaf_used_once_at_the_inlier_width(runs, name):
    run = _run(runs, name)
    n_leaves = sum(k.startswith("param/") for k in run["fx"])
    assert len(run["state"]) == n_leaves
    n_extras = len([s for s in CASES[name].get("inlier_extra_feats", "").split(",") if s])
    assert run["net"].inlier_model.mlp_pre.dense.weight.shape[1] == 6 + n_extras


def test_committed_paths_fixture_is_current(runs):
    """Integer outputs must be equal; float ones may differ in the last bits
    between CPUs (XLA's CPU code generation follows the instruction set)."""
    fresh = _run(runs, "paths-fixture")["fx"]
    committed = dict(np.load(F.OUT_PATHS))
    assert sorted(committed) == sorted(fresh)
    assert json.loads(str(committed["model_json"])) == json.loads(json.dumps(F.MODEL_PATHS))
    assert F.OUT_PATHS.stat().st_size < 1 << 20
    for key, want in committed.items():
        got = np.asarray(fresh[key])
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)
        elif key != "model_json":
            np.testing.assert_array_equal(got, want, err_msg=key)
