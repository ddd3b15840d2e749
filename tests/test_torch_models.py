"""The port's layers, RandLA backbone and keypoint scoring against flax with
the same parameters (converted by `from_jax_params`), on the CPU.

Same float32 arithmetic in a different order (and GroupNorm's variance taken
in two passes where flax uses E[x^2] - E[x]^2): outputs agree to 1e-4.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deepsir_tpu.config import ModelConfig as JaxModelConfig
from deepsir_tpu.models.layers import AttPooling as JaxAttPooling
from deepsir_tpu.models.layers import ConvUnit as JaxConvUnit
from deepsir_tpu.models.randla import RandLA as JaxRandLA
from deepsir_tpu.models.scoring import score_points as jax_score_points
from deepsir_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from deepsir_tpu_torch.config import ModelConfig, check_supported, from_json
from deepsir_tpu_torch.models.layers import AttPooling, ConvUnit
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.models.randla import RandLA
from deepsir_tpu_torch.models.scoring import score_points, top_k_select
from deepsir_tpu_torch.ops.pyramid import Pyramid
from deepsir_tpu_torch.utils.params import (flax_path, from_jax_params,
                                            init_params, unflatten_params)

FIXTURE = Path(__file__).parent / "data" / "torch_parity_small.npz"
TINY = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4),
            d_out=(8, 16), out_feat_dim=16, num_classes=5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _load(module, params):
    module.load_state_dict(from_jax_params(jax.device_get(params), module), strict=True)
    return module.eval()


def _fixture_params():
    return unflatten_params(dict(np.load(FIXTURE)))


def test_from_jax_params_uses_every_leaf_once():
    fx = dict(np.load(FIXTURE))
    net = Network(from_json(str(fx["model_json"])))
    params = _fixture_params()
    sd = from_jax_params(params, net)
    n_leaves = sum(1 for k in fx if k.startswith("param/"))
    assert len(sd) == n_leaves == len(net.state_dict())
    net.load_state_dict(sd, strict=True)
    # a dropped leaf and a stray leaf both raise
    dropped = _fixture_params()
    del dropped["params"]["inlier_model"]["mlp_out"]["kernel"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(dropped, net)
    extra = _fixture_params()
    extra["params"]["mlp_feat"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="left over"):
        from_jax_params(extra, net)


@pytest.mark.parametrize("key,path", [
    ("feat_extractor.enc.1.lfa.att_pooling_2.unit.norm.weight",
     "feat_extractor/enc_1/lfa/att_pooling_2/ConvUnit_0/GroupNorm_0/scale"),
    ("mlp_att.units.3.dense.weight", "mlp_att/ConvUnit_3/Dense_0/kernel"),
    ("inlier_model.mlp_out.weight", "inlier_model/mlp_out/kernel"),
    ("feat_extractor.dec.0.dense.bias", "feat_extractor/dec_0/Dense_0/bias"),
])
def test_flax_path(key, path):
    got, transpose = flax_path(key)
    assert "/".join(got) == path
    assert transpose == path.endswith("kernel")


@pytest.mark.parametrize("c_in,c_out,use_act", [(12, 64, True), (10, 8, True), (16, 32, False)])
def test_conv_unit_matches_flax(rng, c_in, c_out, use_act):
    x = rng.normal(size=(2, 50, 7, c_in)).astype(np.float32)
    jmod = JaxConvUnit(c_out, use_act=use_act)
    params = jmod.init(jax.random.PRNGKey(0), x)["params"]
    # non-trivial affine so the GroupNorm parameters are exercised
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    want = np.asarray(jmod.apply({"params": params}, x))
    got = _load(ConvUnit(c_in, c_out, use_act=use_act), params)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_att_pooling_matches_flax(rng):
    x = rng.normal(size=(2, 40, 8, 16)).astype(np.float32)
    jmod = JaxAttPooling(32)
    params = jmod.init(jax.random.PRNGKey(1), x)["params"]
    want = np.asarray(jmod.apply({"params": params}, x))
    got = _load(AttPooling(16, 32), params)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def _pyramids(rng):
    pts = rng.normal(size=(2, 256, 3)).astype(np.float32)
    jpyr = jax_build_pyramid(pts, num_knn=8, ratios=(4, 4), recall_target=1.0)
    tpyr = Pyramid(*(tuple(torch.tensor(np.asarray(a)).to(
        torch.float32 if a.dtype == np.float32 else torch.int64) for a in field)
        for field in jpyr))
    return pts, jpyr, tpyr


@pytest.mark.parametrize("feat_len,num_classes", [(3, 5), (6, 1)])
def test_randla_matches_flax(rng, feat_len, num_classes):
    """Backbone (feat_len 3) and inlier-net (feat_len 6, one logit) shapes."""
    pts, jpyr, tpyr = _pyramids(rng)
    feats = rng.normal(size=(2, 256, feat_len)).astype(np.float32)
    jcfg = JaxModelConfig(**dict(TINY, feat_len=feat_len))
    jmod = JaxRandLA(jcfg, num_classes=num_classes)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(2), feats, jpyr)["params"]
    jfeat, jlogits = jax.jit(lambda p, f, y: jmod.apply({"params": p}, f, y))(params, feats, jpyr)
    model = _load(RandLA(ModelConfig(**dict(TINY, feat_len=feat_len)), num_classes, feat_len), params)
    with torch.no_grad():
        feat, logits = model(torch.from_numpy(feats), tpyr)
        feat_c, logits_c = model(torch.from_numpy(feats), tpyr, pos_cache=model.pos_cache(tpyr))
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(feat_c.numpy(), feat.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logits_c.numpy(), logits.numpy(), rtol=1e-5, atol=1e-6)


def test_score_points_matches_jax(rng):
    pts, jpyr, tpyr = _pyramids(rng)
    feat = rng.normal(size=(2, 256, 16)).astype(np.float32)
    logits = rng.normal(size=(2, 256, 19)).astype(np.float32)
    neigh = np.asarray(jpyr.neigh_idx[0])
    want = np.asarray(jax_score_points(feat, pts, logits, neigh))
    got = score_points(torch.from_numpy(feat), torch.from_numpy(pts),
                       torch.from_numpy(logits), tpyr.neigh_idx[0]).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (want > 0).mean() > 0.1          # the comparison is not all zeros
    top, sel = top_k_select(torch.from_numpy(got), 10, torch.from_numpy(pts))
    order = np.argsort(-got, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(sel.numpy(), np.take_along_axis(pts, order[..., None], 1))


@pytest.mark.parametrize("option,value", [
    ("use_ppf", True), ("fc_norm", "batch"), ("randla_skips", "post"),
    ("pyramid_order", "hilbert"), ("inlier_extra_feats", "dist,ppf"),
    ("mutual_check_tol", -0.5), ("absolute_pose_solve", True), ("refine_stride", 2),
    ("inlier_num_knn", 8), ("backbone_num_knn", 8), ("inlier_num_layers", 1),
    ("compute_dtype", "bfloat16"),
])
def test_options_outside_the_slice_raise(option, value):
    """An option outside the slice raises, naming itself. The cases whose
    value the slice has admitted since (ADMITTED) build a Network at that
    value, and raise at a value still outside it."""
    if option in ADMITTED:
        Network(ModelConfig(**dict(TINY, **{option: value})))
        if ADMITTED[option] is None:
            return
        value = ADMITTED[option]
    cfg = ModelConfig(**dict(TINY, **{option: value}))
    with pytest.raises(NotImplementedError, match=option):
        check_supported(cfg)
    with pytest.raises(NotImplementedError, match=option):
        Network(cfg)


# option -> a value still outside the slice (None: every value is admitted)
ADMITTED = {"fc_norm": "layer", "randla_skips": "mid", "absolute_pose_solve": None,
            "refine_stride": 0, "compute_dtype": "float16",
            "inlier_num_knn": -1, "backbone_num_knn": -1, "inlier_num_layers": 2}


def test_init_params_is_seeded():
    cfg = ModelConfig(**TINY)
    a, b, c = init_params(cfg, 0), init_params(cfg, 0), init_params(cfg, 1)
    assert a.keys() == b.keys() == c.keys()
    key = "feat_extractor.enc.0.mlp1.dense.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    w = init_params(ModelConfig(), 0)["inlier_model.mlp_mid.dense.weight"]
    assert abs(float(w.std()) - (2.0 / w.shape[1]) ** 0.5) < 0.05 * (2.0 / w.shape[1]) ** 0.5
