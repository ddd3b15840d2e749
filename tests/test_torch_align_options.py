"""The align forward options of the deploy config, the eval script and the
tracked run configs, end to end (`device_batch` -> `Network.forward_align`),
against fresh JAX runs with the same params and inputs, on the CPU.

Cases, at the narrow width of tests/test_torch_align_paths.py:
- the deploy knobs `inlier_num_knn`, `backbone_num_knn` and
  `inlier_num_layers`, each alone and all three together;
- `ForwardOptions.refine_stride` 2 and 4 on shuffled clouds, and 4 on
  Morton-sorted clouds at 4096 points (the subset pyramid is windowed);
- `absolute_pose_solve`;
- the validity masks of a ragged pair, padded by tiling as the data layer
  pads it (the padding makes exact ties, so this case runs the port over
  JAX's pyramids, which the port's own are held against tie for tie);
- `fc_norm="none"`, `fc_norm="batch"` (the stateless batch norm, its
  statistics over each call's points: the backbone's both clouds, each
  side's aggregation) and `randla_skips="post"`, which change the param
  tree;
- fp16 and bf16 point payloads into `device_batch`;
- all of the above that combine, with the flagship's channels and gate (its
  masks zero the tail rows of distinct points).

The params are the port's seeded init, handed to JAX through the inverse of
`from_jax_params`; for each config that changes the param tree the port's
tree is held against the shapes of a JAX init of it (the manifest check).

Tolerances, those of tests/test_torch_align_paths.py: pyramid indices equal
but for near ties (at most 0.1% of entries, each within 1e-5 relative in
float64 distance: JAX ranks by the norm expansion, the port by direct
subtraction), for both clouds' pyramids and the refine path's subset pyramid
that JAX builds inside its forward; iteration-1 pred_idx >= 99.5% equal;
transforms and inlier logits 1e-4 for the pairs whose pyramids and pred_idx
agree in every entry (a flipped neighbour or match changes the input of the
inlier net and the solve), transforms 1e-3 for every pair; `invalid` equal;
scores 1e-4 where the pyramids agree.
"""
import importlib.util
from pathlib import Path
from unittest import mock

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import deepsir_tpu.ops.pyramid as jax_pyramid
from deepsir_tpu.models import ForwardOptions as JaxForwardOptions
from deepsir_tpu.training import device_batch as jax_device_batch
from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.network import ForwardOptions
from deepsir_tpu_torch.ops.pyramid import Pyramid, build_cloud_pyramid
from deepsir_tpu_torch.training import device_batch
from deepsir_tpu_torch.utils.params import init_params, load_network, to_jax_params

_spec = importlib.util.spec_from_file_location(
    "make_torch_parity_fixture",
    Path(__file__).parent / "data" / "make_torch_parity_fixture.py")
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)

DEPLOY = dict(inlier_num_knn=4, inlier_num_layers=1, backbone_num_knn=4)
ITER3 = dict(F.MODEL, num_reg_iter=3)
FLAGSHIP = dict(inlier_extra_feats="dist,recip", clip_weight_thresh=0.05,
                mutual_check=True, mutual_check_tol=0.6)
# name -> (model options, refine_stride, masks, payload dtype); masks
# "tiled" pad the clouds' tails by tiling their heads, as the data layer
# does, "distinct" only mark the tails as padding; the cases
# whose param tree differs from the default one are named in NEW_TREES
NEW_TREES = ("inlier_num_layers", "deploy", "fc_norm-none", "fc_norm-batch",
             "randla_skips-post", "combined")
CASES = {
    "inlier_num_knn": (dict(F.MODEL, inlier_num_knn=4), 1, False, None),
    "backbone_num_knn": (dict(F.MODEL, backbone_num_knn=4), 1, False, None),
    "inlier_num_layers": (dict(F.MODEL, inlier_num_layers=1), 1, False, None),
    "deploy": (dict(F.MODEL, **DEPLOY), 1, False, None),
    "refine_stride-2": (ITER3, 2, False, None),
    "refine_stride-4": (ITER3, 4, False, None),
    "refine_stride-4-morton": (dict(ITER3, num_points=4096, pyramid_order="morton"),
                               4, False, None),
    "absolute_pose_solve": (dict(ITER3, absolute_pose_solve=True), 1, False, None),
    "masks": (F.MODEL, 1, "tiled", None),
    "fc_norm-none": (dict(F.MODEL, fc_norm="none"), 1, False, None),
    "fc_norm-batch": (dict(F.MODEL, fc_norm="batch"), 1, False, None),
    "randla_skips-post": (dict(F.MODEL, randla_skips="post"), 1, False, None),
    "payload-float16": (F.MODEL, 1, False, np.float16),
    "payload-bfloat16": (F.MODEL, 1, False, ml_dtypes.bfloat16),
    "combined": (dict(ITER3, **DEPLOY, **FLAGSHIP, absolute_pose_solve=True,
                      fc_norm="none", randla_skips="post"), 2, "distinct", np.float16),
}
RAW = (700, 900)            # real points of the ragged pair's two clouds


def make_arrays(model_cfg, masks, payload):
    arrays = F.make_arrays(F.SEED, model_cfg)
    if masks:
        n = model_cfg["num_points"]
        for side, raw in zip(("src", "ref"), RAW):
            pts = arrays[f"points_{side}"]
            if masks == "tiled":
                arrays[f"points_{side}"] = np.stack([np.resize(c[:raw], c.shape) for c in pts])
            arrays[f"mask_{side}"] = np.tile((np.arange(n) < raw).astype(np.float32),
                                             (len(pts), 1))
    if payload is not None:
        for side in ("src", "ref"):
            arrays[f"points_{side}"] = arrays[f"points_{side}"].astype(payload)
    return arrays


def _differing_pairs(port_pyr, jax_levels, cfg):
    """Per pair, whether any pyramid entry differs from JAX's. Every
    difference is a tie: exact (equal float64 distances, as between a point
    and its tiled copy), or near (at most 0.1% of entries, each within 1e-5
    relative)."""
    bad_pair = np.zeros(F.BATCH, bool)
    strided = cfg.pyramid_order == "morton"
    for lvl, r in enumerate(cfg.sub_sampling_ratio):
        xyz = port_pyr.xyz[lvl].numpy().astype(np.float64)
        nxt = xyz[:, ::r if strided else 1][:, :xyz.shape[1] // r]
        for what, got, want, cand in (
                (f"neigh_idx[{lvl}]", port_pyr.neigh_idx[lvl], jax_levels[0][lvl], xyz),
                (f"interp_idx[{lvl}]", port_pyr.interp_idx[lvl], jax_levels[1][lvl], nxt)):
            got = got.numpy().reshape(F.BATCH, xyz.shape[1], -1)
            want = np.asarray(want, np.int64).reshape(got.shape)
            b, i, j = np.nonzero(got != want)
            d_g = ((cand[b, got[b, i, j]] - xyz[b, i]) ** 2).sum(-1)
            d_w = ((cand[b, want[b, i, j]] - xyz[b, i]) ** 2).sum(-1)
            near = d_g != d_w
            assert near.sum() <= 1e-3 * got.size, what
            np.testing.assert_allclose(d_g[near], d_w[near], rtol=1e-5, atol=1e-9,
                                       err_msg=what)
            bad_pair[b] = True
    return bad_pair


def _torch_pyramid(jpyr):
    return Pyramid(*(tuple(torch.tensor(np.asarray(a, np.float32 if k == "xyz" else np.int64))
                           for a in field) for k, field in jpyr._asdict().items()))


@pytest.fixture(scope="module")
def runs():
    """Case name -> its JAX and port runs, made on first use."""
    return {}


def _run(runs, name):
    if name in runs:
        return runs[name]
    model_cfg, stride, masks, payload = CASES[name]
    arrays = make_arrays(model_cfg, masks, payload)
    cfg, model, _ = F._setup(model_cfg)
    opts = JaxForwardOptions(num_iter=model_cfg["num_reg_iter"], clip_weight=True,
                             refine_stride=stride)
    port_cfg = ModelConfig(**model_cfg)
    state = init_params(port_cfg, seed=1)
    params = to_jax_params(state)
    shapes = None
    if name in NEW_TREES:
        shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0),
                                                     jax_device_batch(cfg, a), opts), arrays)

    # the subset pyramid JAX builds inside the refine path, seen on its way out
    subset = {}
    build = jax_pyramid.build_pyramid

    def build_and_keep(xyz, *args, **kw):
        pyr = build(xyz, *args, **kw)
        jax.debug.callback(lambda n, u: subset.update(levels=(n, u)),
                           pyr.neigh_idx, pyr.interp_idx)
        return pyr

    def fwd(p, a):
        batch = jax_device_batch(cfg, a)
        with mock.patch.object(jax_pyramid, "build_pyramid", build_and_keep):
            out = model.apply(p, batch, opts, train=False)[1]
        return out, batch.pyramid_src, batch.pyramid_ref

    want, jpyr_src, jpyr_ref = jax.device_get(jax.jit(fwd)(params, arrays))

    net = load_network(port_cfg, state, device="cpu")
    batch = device_batch(port_cfg, arrays, device="cpu")
    got = net.forward_align(batch, ForwardOptions(num_iter=model_cfg["num_reg_iter"],
                                                  clip_weight=True, refine_stride=stride))
    differ = np.zeros(F.BATCH, bool)
    for port_pyr, jpyr in ((batch.pyramid_src, jpyr_src), (batch.pyramid_ref, jpyr_ref)):
        differ |= _differing_pairs(port_pyr, (jpyr.neigh_idx, jpyr.interp_idx), port_cfg)
    if masks == "tiled":
        # exact ties order as they fall: run the port over JAX's pyramids
        batch = batch._replace(pyramid_src=_torch_pyramid(jpyr_src),
                               pyramid_ref=_torch_pyramid(jpyr_ref))
        got = net.forward_align(batch, ForwardOptions(num_iter=model_cfg["num_reg_iter"],
                                                      clip_weight=True))
        differ[:] = False
    if stride > 1:
        sub = build_cloud_pyramid(port_cfg, batch.points_src[:, ::stride, :3].contiguous())
        differ |= _differing_pairs(sub, subset["levels"], port_cfg)
    runs[name] = dict(params=params, shapes=shapes, want=want, got=got, batch=batch,
                      arrays=arrays, net=net, pyramids_differ=differ)
    return runs[name]


@pytest.mark.parametrize("name", NEW_TREES)
def test_param_tree_matches_a_jax_init(runs, name):
    run = _run(runs, name)
    want = {p: s.shape for p, s in jax.tree_util.tree_flatten_with_path(run["shapes"])[0]}
    got = {p: np.shape(a) for p, a in jax.tree_util.tree_flatten_with_path(run["params"])[0]}
    assert got == want
    model_cfg = CASES[name][0]
    n_levels = model_cfg.get("inlier_num_layers") or len(model_cfg["d_out"])
    assert len(run["net"].inlier_model.enc) == len(run["net"].inlier_model.dec) == n_levels


@pytest.mark.parametrize("name", list(CASES))
def test_align_outputs(runs, name):
    run = _run(runs, name)
    want, got = run["want"], run["got"]
    model_cfg, stride, _, _ = CASES[name]
    n_iter = model_cfg["num_reg_iter"]
    n_sub = len(range(0, model_cfg["num_points"], stride))
    assert got.transforms.shape == want.transforms.shape == (n_iter, F.BATCH, 3, 4)
    n_rows = n_iter - (stride > 1)
    assert tuple(got.pred_idx.shape) == want.pred_idx.shape == (n_rows, F.BATCH, n_sub)
    assert tuple(got.inlier_logits.shape) == want.inlier_logits.shape
    np.testing.assert_array_equal(got.pt_src.numpy(), np.asarray(want.pt_src, np.float32))
    pyr_same = ~run["pyramids_differ"]
    for key in ("score_src", "score_ref"):
        np.testing.assert_allclose(getattr(got, key).numpy()[pyr_same],
                                   getattr(want, key)[pyr_same],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    pred, want_idx = got.pred_idx.numpy(), np.asarray(want.pred_idx, np.int64)
    assert (pred[0] == want_idx[0]).mean() >= 0.995
    np.testing.assert_array_equal(got.invalid.numpy(), want.invalid)
    np.testing.assert_allclose(got.transforms.numpy(), want.transforms, atol=1e-3)
    same = (pred == want_idx).all(axis=(0, 2)) & pyr_same
    assert same.any()
    np.testing.assert_allclose(got.transforms.numpy()[:, same], want.transforms[:, same],
                               atol=1e-4)
    np.testing.assert_allclose(got.inlier_logits.numpy()[:, same],
                               want.inlier_logits[:, same], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["masks", "payload-float16", "payload-bfloat16"])
def test_device_batch_inputs(runs, name):
    run = _run(runs, name)
    batch, arrays = run["batch"], run["arrays"]
    for side in ("src", "ref"):
        pts = getattr(batch, f"points_{side}")
        assert pts.dtype == torch.float32
        np.testing.assert_array_equal(pts.numpy(), arrays[f"points_{side}"].astype(np.float32))
        mask = getattr(batch, f"mask_{side}")
        if f"mask_{side}" in arrays:
            np.testing.assert_array_equal(mask.numpy(), arrays[f"mask_{side}"])
        else:
            assert mask is None


def test_masked_rows_take_no_vote(runs):
    """The masks reach the solve: without them the padding rows vote too,
    and the poses move."""
    run = _run(runs, "masks")
    batch = run["batch"]._replace(mask_src=None, mask_ref=None)
    out = run["net"].forward_align(batch, ForwardOptions(num_iter=F.MODEL["num_reg_iter"],
                                                         clip_weight=True))
    assert not np.allclose(out.transforms.numpy(), run["got"].transforms.numpy(), atol=1e-6)


def test_other_arrays_still_raise():
    cfg = ModelConfig(**F.MODEL)
    arrays = dict(F.make_arrays(F.SEED, F.MODEL), normals_src=np.zeros((2, 1024, 3), np.float32))
    with pytest.raises(NotImplementedError, match="normals_src"):
        device_batch(cfg, arrays, device="cpu")


def test_refine_stride_leaving_too_few_points_raises():
    cfg = ModelConfig(**F.MODEL)
    net = load_network(cfg, init_params(cfg, seed=1), device="cpu")
    batch = device_batch(cfg, F.make_arrays(F.SEED, F.MODEL), device="cpu")
    with pytest.raises(ValueError, match="refine_stride=100"):
        net.forward_align(batch, ForwardOptions(num_iter=2, refine_stride=100))
    # one iteration never refines, whatever the stride
    out = net.forward_align(batch, ForwardOptions(num_iter=1, refine_stride=100))
    assert tuple(out.pred_idx.shape) == (1, F.BATCH, F.MODEL["num_points"])
