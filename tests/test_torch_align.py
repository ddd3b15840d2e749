"""The port's align inference forward, end to end (`device_batch` ->
`Network.forward_align`), against the JAX package with the same params and
inputs, on the CPU; and the committed JAX fixture against a fresh run.

Tolerances and why:
- pyramid indices: equal. Both searches are exact; a near-tie could flip an
  index, but none does on these inputs.
- descriptors: 1e-4. Same float32 arithmetic in another summation order
  through ~40 layers.
- pred_idx of iteration 1: >= 99.5% of rows agree. A descriptor near-tie may
  legally pick another ref point.
- transforms: 1e-4, held where every iteration's pred_idx agrees (a flipped
  match changes the solve's input).
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

from deepsir_tpu.training import device_batch as jax_device_batch
from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.network import ForwardOptions, Network
from deepsir_tpu_torch.training import device_batch
from deepsir_tpu_torch.utils.params import (from_jax_params, load_network,
                                            unflatten_params)

_spec = importlib.util.spec_from_file_location(
    "make_torch_parity_fixture",
    Path(__file__).parent / "data" / "make_torch_parity_fixture.py")
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)

INPUTS = ("points_src", "points_ref", "transform_gt")


@pytest.fixture(scope="module")
def jax_run():
    """A fresh JAX run of the fixture, plus JAX's descriptors on the same batch."""
    fx = F.build()
    cfg, model, _ = F._setup()
    params = unflatten_params(fx)

    def descriptors(mdl, batch):
        fs0, ls, fr0, lr, _, _ = mdl.backbone_pair(batch, train=False)
        ss, sr = mdl.score_pair(batch, fs0, fr0, ls, lr)
        return (mdl.aggregate_side(batch.points_src[..., :3], fs0, ss),
                mdl.aggregate_side(batch.points_ref[..., :3], fr0, sr), ss, sr)

    arrays = {k: fx[k] for k in INPUTS}
    desc = jax.jit(lambda p, a: model.apply(p, jax_device_batch(cfg, a),
                                            method=descriptors))(params, arrays)
    return fx, [np.asarray(d) for d in desc]


@pytest.fixture(scope="module")
def port_run(jax_run):
    fx, _ = jax_run
    cfg = ModelConfig(**F.MODEL)
    model = load_network(cfg, from_jax_params(unflatten_params(fx), Network(cfg)),
                         device="cpu")
    batch = device_batch(cfg, {k: fx[k] for k in INPUTS}, device="cpu")
    with torch.no_grad():
        fs0, ls, fr0, lr = model.backbone_pair(batch)
        ss, sr = model.score_pair(batch, fs0, fr0, ls, lr)
        desc = (model.aggregate_side(batch.points_src[..., :3], fs0, ss),
                model.aggregate_side(batch.points_ref[..., :3], fr0, sr), ss, sr)
    out = model.forward_align(batch, ForwardOptions(num_iter=F.MODEL["num_reg_iter"],
                                                    clip_weight=True))
    return batch, [d.numpy() for d in desc], out


def test_committed_fixture_is_current(jax_run):
    """Integer outputs must be equal; float ones may differ in the last bits
    between CPUs (XLA's CPU code generation follows the instruction set)."""
    fresh, _ = jax_run
    committed = dict(np.load(F.OUT))
    assert sorted(committed) == sorted(fresh)
    assert json.loads(str(committed["model_json"])) == json.loads(json.dumps(F.MODEL))
    for key, want in committed.items():
        got = np.asarray(fresh[key])
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)
        elif key != "model_json":
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_pyramids_equal(jax_run, port_run):
    fx, _ = jax_run
    batch, _, _ = port_run
    for side, pyr in (("src", batch.pyramid_src), ("ref", batch.pyramid_ref)):
        for lvl in range(len(F.MODEL["d_out"])):
            np.testing.assert_array_equal(pyr.neigh_idx[lvl].numpy(),
                                          fx[f"{side}_neigh_idx_{lvl}"])
            np.testing.assert_array_equal(pyr.interp_idx[lvl].numpy(),
                                          fx[f"{side}_interp_idx_{lvl}"])


def test_descriptors_and_scores(jax_run, port_run):
    _, jdesc = jax_run
    _, desc, _ = port_run
    for name, got, want in zip(("desc_src", "desc_ref", "score_src", "score_ref"),
                               desc, jdesc):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


def test_align_outputs(jax_run, port_run):
    fx, _ = jax_run
    _, _, out = port_run
    pred = out.pred_idx.numpy()
    assert pred.shape == fx["pred_idx"].shape
    assert (pred[0] == fx["pred_idx"][0]).mean() >= 0.995
    np.testing.assert_array_equal(out.invalid.numpy(), fx["invalid"])
    same = (pred == fx["pred_idx"]).all(axis=(0, 2))          # per pair
    assert same.any()
    np.testing.assert_allclose(out.transforms.numpy()[:, same],
                               fx["transforms"][:, same], atol=1e-4)
    np.testing.assert_allclose(out.inlier_logits.numpy()[:, same],
                               fx["inlier_logits"][:, same], rtol=1e-4, atol=1e-4)


def test_device_batch_rejects_unported_keys(jax_run):
    fx, _ = jax_run
    arrays = {k: fx[k] for k in INPUTS}
    # the validity masks and the labels are ported; per-point normals are not
    arrays["normals_src"] = np.zeros(fx["points_src"].shape[:2] + (3,), np.float32)
    with pytest.raises(NotImplementedError, match="normals_src"):
        device_batch(ModelConfig(**F.MODEL), arrays, device="cpu")
