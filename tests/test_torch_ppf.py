"""Point-pair features (`use_ppf`) in the port against the JAX package, on
the CPU, in fp32.

- `ppf_grouping` (deepsir_tpu/models/randla.py:58-78) within 1e-6 of JAX's,
  on unit normals and on the zero normals of the Synthetic reader (angles
  0: atan2(0, 0)); it builds no graph.
- RandLA on PPF inputs (`mlp_pre` a (10, 12) Dense, its output averaged over
  the neighbours, `enc.0` reading 12 channels) and the label pipeline's
  forward within 1e-5 of each output's scale; one label training step by
  tests/test_torch_pipelines.py's rules (grads 1e-4, params 1e-5 of each
  leaf's scale).
- The parameter tree: `from_jax_params` uses every flax leaf once, and
  `to_jax_params`, `init_params` and the Adam-state mapping give JAX's tree.
- `use_ppf` with feat_len < 6 raises, naming the option.
"""
import jax
import numpy as np
import pytest
import torch
from flax.serialization import to_state_dict

import test_torch_pipelines as P
from deepsir_tpu.config import ModelConfig as JaxModelConfig
from deepsir_tpu.models import Network as JaxNetwork
from deepsir_tpu.models.randla import RandLA as JaxRandLA
from deepsir_tpu.models.randla import ppf_grouping as jax_ppf_grouping
from deepsir_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from deepsir_tpu.training import make_optimizer as jax_make_optimizer
from deepsir_tpu_torch.config import ModelConfig, check_supported
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.models.randla import RandLA, ppf_grouping
from deepsir_tpu_torch.ops.pyramid import Pyramid
from deepsir_tpu_torch.training import device_batch, forward_step, make_optimizer, train_step
from deepsir_tpu_torch.utils.params import (_flatten, from_jax_params, init_params,
                                            to_jax_opt_state, to_jax_params)

PPF = dict(use_ppf=True, feat_len=6)
TINY = dict(P.MODEL, num_classes=5, **PPF)


def _unit(rng, shape):
    n = rng.normal(size=shape)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def _pyramids(rng, n=256):
    pts = rng.normal(size=(2, n, 3)).astype(np.float32)
    jpyr = jax_build_pyramid(pts, num_knn=8, ratios=(4, 4), recall_target=1.0)
    tpyr = Pyramid(*(tuple(torch.tensor(np.asarray(a)).to(
        torch.float32 if a.dtype == np.float32 else torch.int64) for a in field)
        for field in jpyr))
    return pts, jpyr, tpyr


@pytest.mark.parametrize("normals", ["unit", "zero"])
def test_ppf_grouping_matches_jax(rng, normals):
    pts, jpyr, tpyr = _pyramids(rng)
    nrm = _unit(rng, pts.shape) if normals == "unit" else np.zeros_like(pts)
    want = np.asarray(jax_ppf_grouping(pts, nrm, jpyr.neigh_idx[0]))
    xyz = torch.from_numpy(pts).requires_grad_()
    got = ppf_grouping(xyz, torch.from_numpy(nrm), tpyr.neigh_idx[0])
    assert got.shape == (2, 256, 8, 10) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.isfinite(want).all()
    # the first neighbour is the point itself: d = 0, and both angles to d are
    # atan2(0, 0) = 0
    assert (got[:, :, 0, [3, 4, 5, 6, 7, 9]] == 0).all()
    if normals == "zero":
        assert (got[..., 6:9] == 0).all()


def _assert_scaled(got, want, rel, what):
    P.assert_scaled(np.asarray(got), np.asarray(want), rel, what)


def test_randla_on_ppf_matches_flax(rng):
    pts, jpyr, tpyr = _pyramids(rng)
    feats = np.concatenate([pts, _unit(rng, pts.shape)], axis=-1)
    jm = JaxRandLA(JaxModelConfig(**TINY), num_classes=5)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), feats, jpyr)["params"]
    jfeat, jlogits = jax.jit(lambda p, f, y: jm.apply({"params": p}, f, y))(params, feats, jpyr)
    model = RandLA(ModelConfig(**TINY), 5, 6)
    model.load_state_dict(from_jax_params(jax.device_get(params), model), strict=True)
    assert tuple(model.mlp_pre.dense.weight.shape) == (12, 10)
    assert model.enc[0].mlp1.dense.in_features == 12
    with torch.no_grad():
        feat, logits = model(torch.from_numpy(feats), tpyr)
        cached = model(torch.from_numpy(feats), tpyr, pos_cache=model.pos_cache(tpyr))
    _assert_scaled(feat.numpy(), jfeat, 1e-5, "feat")
    _assert_scaled(logits.numpy(), jlogits, 1e-5, "logits")
    assert torch.equal(cached[0], feat) and torch.equal(cached[1], logits)


def ppf_arrays(jcfg, n=2):
    """The Synthetic pairs with unit normals in channels 3:6 (the reader
    leaves them 0)."""
    arrays = P.synthetic_arrays(jcfg, n)
    rng = np.random.default_rng(7)
    for side in ("src", "ref"):
        pts = arrays[f"points_{side}"]
        pts[..., 3:6] = _unit(rng, pts[..., :3].shape)
    return arrays


def test_label_forward_on_ppf_matches_jax():
    jcfg, cfgs = P.configs("label", PPF)
    arrays = ppf_arrays(jcfg)
    state = init_params(cfgs.model, seed=3, pipeline="label")
    model = Network(cfgs.model, "label")
    model.load_state_dict(state)
    got = forward_step(model, cfgs.model, arrays)
    batch = device_batch(cfgs.model, arrays, device="cpu")
    net = JaxNetwork(jcfg.model, pipeline="label")
    _, want = jax.jit(lambda p, b: net.apply(p, b, train=False))(
        to_jax_params(state), P.jax_batch(arrays, batch))
    for field in ("feat_src", "feat_ref", "logits_src", "logits_ref"):
        _assert_scaled(getattr(got, field).numpy(), getattr(want, field), 1e-5, field)


def test_label_step_on_ppf_matches_jax():
    """One label step with use_ppf against JAX's, on unit normals."""
    P.check_step("label", PPF, {}, ppf_arrays)


@pytest.mark.parametrize("pipeline", ["label", "feat", "align"])
def test_ppf_params_tree_is_jaxs(pipeline):
    """JAX's PPF tree loads with every leaf used once and round-trips; the
    port's seeded tree and its Adam state have JAX's paths and shapes; the
    inlier net of align never takes PPF inputs."""
    jcfg, cfgs = P.configs(pipeline, PPF)
    arrays = ppf_arrays(jcfg)
    batch = device_batch(cfgs.model, arrays, device="cpu")
    net = JaxNetwork(jcfg.model, pipeline=pipeline)
    jparams = jax.device_get(jax.jit(lambda b: net.init(jax.random.PRNGKey(0), b))(
        P.jax_batch(arrays, batch)))
    model = Network(cfgs.model, pipeline)
    state = from_jax_params(jparams, model)
    assert len(state) == len(jax.tree_util.tree_leaves(jparams)) == len(model.state_dict())
    model.load_state_dict(state)
    back = to_jax_params(model.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    seeded = _flatten(to_jax_params(init_params(cfgs.model, seed=0, pipeline=pipeline)))
    assert {k: v.shape for k, v in seeded.items()} == \
        {k: np.asarray(v).shape for k, v in _flatten(jparams).items()}
    fe = jparams["params"]["feat_extractor"]
    assert fe["mlp_pre"]["Dense_0"]["kernel"].shape == (10, 12)
    if pipeline == "align":
        assert jparams["params"]["inlier_model"]["mlp_pre"]["Dense_0"]["kernel"].shape == (6, 8)
    # optax's state as flax serialises it, the layout to_jax_opt_state writes
    want = to_state_dict(jax.device_get(jax_make_optimizer(jcfg, 1).init(jparams)))
    got = to_jax_opt_state(model, make_optimizer(model))
    assert {k: np.shape(v) for k, v in _flatten(got).items()} == \
        {k: np.shape(v) for k, v in _flatten(want).items()}


@pytest.mark.parametrize("feat_len", [3, 4, 5])
def test_ppf_needs_the_normals(feat_len):
    cfg = ModelConfig(**dict(P.MODEL, use_ppf=True, feat_len=feat_len))
    with pytest.raises(NotImplementedError, match="use_ppf") as info:
        check_supported(cfg)
    assert f"feat_len={feat_len}" in str(info.value)
    with pytest.raises(NotImplementedError, match="use_ppf"):
        Network(cfg, "label")


def test_ppf_label_step_runs_on_zero_normals_without_nans():
    """Runs of the train command have zero normals (the Synthetic reader): the step is
    applied and every grad is finite."""
    jcfg, cfgs = P.configs("label", PPF)
    arrays = P.synthetic_arrays(jcfg)
    assert not arrays["points_src"][..., 3:6].any()
    model = Network(cfgs.model, "label")
    model.load_state_dict(init_params(cfgs.model, seed=1, pipeline="label"))
    out = train_step(model, make_optimizer(model), cfgs, arrays, torch.Generator(), 1)
    assert not out["skipped"]
    assert all(torch.isfinite(g).all() for g in out["grads"].values() if g is not None)
