"""The port's label and feat pipelines against the JAX package's, on the CPU
at narrow widths (256 points, d_out (8, 16), out_feat_dim 16, 8 neighbours,
seeded weights from `init_params`), over the port's pyramids (JAX's CPU KNN
orders near ties by the norm expansion).

- `forward_pair` in inference (`training.forward_step`) against a fresh
  `Network.apply(train=False)`: every output within 1e-5 of its largest
  magnitude, on `fc_norm` group, none and batch, `randla_skips` pre and
  post, `num_sub` -1 and 64 (the same 64 points kept).
- One `train_step` of each pipeline at `dropout_rate` 0 against JAX's
  `value_and_grad(compute_loss)` and `tx.update`: loss 1e-5 relative, each
  trained leaf's grad within 1e-4 of the leaf's largest magnitude, params
  after the step within 1e-5; the frozen leaves bit-identical, and the
  optimizer holding the pipeline's groups only.

A bias that feeds a norm subtracting each channel's mean (a GroupNorm of
one channel per group, as at these widths in the backbone's first level,
or any batch norm) is blind: its grad is rounding noise in both packages,
which Adam turns into steps of about lr. Those leaves are held to the
noise bound of tests/test_torch_train.py (below 1e-6 of the largest grad
of the network) and left out of the params comparison; every other leaf
is held to the rule above. Adam's first step moves an entry by
lr * g / (|g| + 1e-8): where |g| is near its eps that step amplifies the
grads' rounding by up to lr / eps = 1e5 (a grad of 1.06e-8 against JAX's
1.31e-8 moves the param 5.3e-5 apart). The few entries whose JAX grad is
below 100 eps (at most one entry or 1% of a leaf, asserted) are held instead to that
update of the port's own grad, within 1e-7, their grads being held by the
leaf rule.

Also: dropout before `fc_label` draws from the caller's generator, once
per backbone pass, reproducibly.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsir_tpu.config import (Config, DataConfig, LossConfig as JaxLossConfig,
                                ModelConfig as JaxModelConfig, TrainConfig as JaxTrainConfig)
from deepsir_tpu.data.base import Loader
from deepsir_tpu.data.synthetic import SyntheticPairs
from deepsir_tpu.models import Network as JaxNetwork
from deepsir_tpu.models.network import PairBatch as JaxPairBatch
from deepsir_tpu.ops.pyramid import Pyramid as JaxPyramid
from deepsir_tpu.training import (batch_arrays_only, compute_loss as jax_compute_loss,
                                  make_optimizer as jax_make_optimizer)
from deepsir_tpu_torch.config import LossConfig, ModelConfig, RunConfig, TrainConfig
from deepsir_tpu_torch.models.layers import ConvUnit
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.models.randla import RandLA
from deepsir_tpu_torch.training import (adam_count, device_batch, forward_step, make_optimizer,
                                        train_step)
from deepsir_tpu_torch.utils.params import (TRAINABLE_GROUPS, flax_path, init_params,
                                            to_jax_params, trainable_parameters)

MODEL = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4),
             d_out=(8, 16), out_feat_dim=16, dropout_rate=0.0)
TRAIN = dict(lr=1e-3, lr_decay_epoch=1, lr_decay_ratio=0.5, lr_clip=3e-4)
ADAM_EPS = 1e-8
# name -> (pipeline, ModelConfig options)
FORWARD = {
    "label-group": ("label", {}),
    "label-batch-post": ("label", dict(fc_norm="batch", randla_skips="post")),
    "label-none": ("label", dict(fc_norm="none")),
    "feat-group": ("feat", {}),
    "feat-batch": ("feat", dict(fc_norm="batch")),
    "feat-none-post": ("feat", dict(fc_norm="none", randla_skips="post")),
    "feat-group-sub64": ("feat", dict(num_sub=64)),
    "feat-batch-post-sub64": ("feat", dict(fc_norm="batch", randla_skips="post", num_sub=64)),
}
# name -> (pipeline, ModelConfig options, LossConfig options)
STEPS = {
    "label-group": ("label", {}, {}),
    "label-batch": ("label", dict(fc_norm="batch"), {}),
    "feat-group": ("feat", {}, {}),
    "feat-batch-sub64-mask": ("feat", dict(fc_norm="batch", num_sub=64),
                              dict(overlap_det_mask=True, det_loss_weight=0.5)),
    "feat-tiled": ("feat", dict(randla_skips="post"), dict(circle_loss_tile=100)),
}


def configs(pipeline, model_kw, loss_kw=None):
    model = dict(MODEL, **model_kw)
    loss_kw = loss_kw or {}
    jcfg = Config(pipeline=pipeline, model=JaxModelConfig(**model),
                  data=DataConfig(dataset_type="Synthetic"),
                  loss=JaxLossConfig(**loss_kw), train=JaxTrainConfig(**TRAIN)).resolved()
    cfgs = RunConfig(ModelConfig(**model),
                     LossConfig(**loss_kw, thres_radius=jcfg.loss.thres_radius),
                     TrainConfig(**TRAIN), pipeline)
    return jcfg, cfgs


def synthetic_arrays(jcfg, n=2):
    ds = SyntheticPairs(jcfg, "train", size=n)
    return batch_arrays_only(next(iter(Loader(ds, batch_size=n, shuffle=False, num_workers=1))))


def jax_pyramid(pyr):
    return JaxPyramid(*(tuple(jnp.asarray(a.numpy().astype(np.float32 if k == "xyz" else
                                                          np.int32)) for a in field)
                        for k, field in pyr._asdict().items()))


def jax_batch(arrays, batch):
    return JaxPairBatch(jnp.asarray(arrays["points_src"]), jnp.asarray(arrays["points_ref"]),
                        jax_pyramid(batch.pyramid_src), jax_pyramid(batch.pyramid_ref),
                        jnp.asarray(arrays["transform_gt"]),
                        labels_src=jnp.asarray(arrays["labels_src"]),
                        labels_ref=jnp.asarray(arrays["labels_ref"]))


def leaf(tree, key):
    """The flax leaf of port parameter `key`, in the port's layout."""
    path, transpose = flax_path(key)
    tree = tree["params"]
    for p in path:
        tree = tree[p]
    arr = np.asarray(tree)
    return arr.T if transpose else arr


def blind_biases(model):
    """Dense biases that a per-channel mean subtraction cancels: before a
    GroupNorm of one channel per group, or before a batch norm."""
    out = set()
    for name, m in model.named_modules():
        if not isinstance(m, ConvUnit):
            continue
        if (m.norm is not None and m.norm.groups == m.dense.out_features) or m.scale is not None:
            out.add(f"{name}.dense.bias")
    return out


def assert_scaled(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("name", list(FORWARD))
def test_forward_pair_equals_jax(name):
    pipeline, model_kw = FORWARD[name]
    jcfg, cfgs = configs(pipeline, model_kw)
    arrays = synthetic_arrays(jcfg)
    state = init_params(cfgs.model, seed=3, pipeline=pipeline)
    model = Network(cfgs.model, pipeline)
    model.load_state_dict(state)
    got = forward_step(model, cfgs.model, arrays)
    batch = device_batch(cfgs.model, arrays, device="cpu")
    net = JaxNetwork(jcfg.model, pipeline=pipeline)
    _, want = jax.jit(lambda p, b: net.apply(p, b, train=False))(
        to_jax_params(state), jax_batch(arrays, batch))
    n = model_kw.get("num_sub", -1) if pipeline == "feat" else -1
    rows = n if n > 0 else MODEL["num_points"]
    for field, value in want._asdict().items():
        if value is None:
            assert getattr(got, field) is None, field
            continue
        assert_scaled(getattr(got, field).numpy(), value, 1e-5, field)
    assert got.feat_src.shape == (2, rows, MODEL["out_feat_dim"])
    assert got.logits_src.shape == (2, MODEL["num_points"], 19)
    assert (got.score_src is None) == (pipeline == "label")
    if pipeline == "label":
        # label normalises the backbone's features
        np.testing.assert_allclose(torch.linalg.vector_norm(got.feat_src, dim=-1).numpy(), 1.0,
                                   rtol=1e-5)
    assert not got.feat_src.requires_grad


def test_network_builds_each_pipelines_groups_only():
    cfg = ModelConfig(**MODEL)
    tops = {p: {k.split(".")[0] for k in Network(cfg, p).state_dict()}
            for p in ("label", "feat", "align")}
    assert tops == {"label": {"feat_extractor"},
                    "feat": {"feat_extractor", "mlp_feat", "mlp_att", "mlp_proj"},
                    "align": {"feat_extractor", "mlp_feat", "mlp_att", "mlp_proj",
                              "inlier_model"}}
    for pipeline, group in TRAINABLE_GROUPS.items():
        model = Network(cfg, pipeline)
        held = {id(p) for g in make_optimizer(model).param_groups for p in g["params"]}
        want = {id(p) for n, p in model.named_parameters() if n.split(".")[0] in group}
        assert held == want and want
    with pytest.raises(ValueError, match="pipeline"):
        Network(cfg, "segment")


def run_jax_step(jcfg, params, batch):
    """JAX's loss, aux, grads and params after one Adam update, in one jit
    (the JAX package jits its train step too)."""
    model = JaxNetwork(jcfg.model, pipeline=jcfg.pipeline)
    rng = jax.random.PRNGKey(0)
    tx = jax_make_optimizer(jcfg, 1)

    def step(q):
        (loss, aux), grads = jax.value_and_grad(
            lambda q: jax_compute_loss(jcfg, model, q, batch, None, True, rng), has_aux=True)(q)
        updates, _ = tx.update(grads, tx.init(q), q)
        return loss, aux, grads, optax.apply_updates(q, updates)
    loss, aux, grads, params = jax.device_get(jax.jit(step)(params))
    return float(loss), aux, grads, params


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_equals_jax_and_keeps_frozen_params(name):
    pipeline, model_kw, loss_kw = STEPS[name]
    check_step(pipeline, model_kw, loss_kw)


def check_step(pipeline, model_kw, loss_kw, make_arrays=synthetic_arrays):
    """One train_step of `pipeline` against JAX's (the module docstring's
    rules) on the arrays `make_arrays(jcfg)`."""
    jcfg, cfgs = configs(pipeline, model_kw, loss_kw)
    arrays = make_arrays(jcfg)
    state = init_params(cfgs.model, seed=3, pipeline=pipeline)
    model = Network(cfgs.model, pipeline)
    model.load_state_dict(state)
    batch = device_batch(cfgs.model, arrays, device="cpu")
    want_loss, want_aux, want_grads, want_params = run_jax_step(
        jcfg, to_jax_params(state), jax_batch(arrays, batch))
    opt = make_optimizer(model)
    out = train_step(model, opt, cfgs, arrays, torch.Generator().manual_seed(0), 1)
    assert not out["skipped"] and adam_count(opt) == 1
    np.testing.assert_allclose(out["loss"].item(), want_loss, rtol=1e-5)
    assert out["acc"].item() == pytest.approx(float(want_aux["acc"]), rel=1e-6)
    assert out["lr"] == pytest.approx(TRAIN["lr"])

    trained = dict(trainable_parameters(model))
    assert set(out["grads"]) == set(trained)
    blind = blind_biases(model)
    refs = {k: leaf(want_grads, k) for k in out["grads"]}
    largest = max(float(np.abs(r).max()) for r in refs.values())
    for key, grad in out["grads"].items():
        if key in blind:
            assert max(float(grad.abs().max()), float(np.abs(refs[key]).max())) \
                <= 1e-6 * largest, key
        else:
            assert_scaled(grad.numpy(), refs[key], 1e-4, key)
    # JAX's frozen grads: feat cuts the backbone's graph, so they are zero
    for key in state:
        if key not in trained:
            assert not np.abs(leaf(want_grads, key)).any(), key
    changed = 0
    for key, value in model.state_dict().items():
        if key not in trained:
            assert torch.equal(value, state[key]), key              # frozen: bit-identical
            continue
        changed += not torch.equal(value, state[key])
        if key in blind:
            continue
        eps_scale = np.abs(refs[key]) < 100 * ADAM_EPS
        assert eps_scale.sum() <= max(1, 0.01 * eps_scale.size), key
        got, want = value.numpy(), leaf(want_params, key)
        np.testing.assert_allclose(got[~eps_scale], want[~eps_scale], rtol=0, atol=1e-5,
                                   err_msg=key)
        g = out["grads"][key].numpy()[eps_scale].astype(np.float64)
        own = state[key].numpy()[eps_scale] - TRAIN["lr"] * g / (np.abs(g) + ADAM_EPS)
        np.testing.assert_allclose(got[eps_scale], own, rtol=0, atol=1e-7, err_msg=key)
    assert changed > 0.9 * len(trained)


@pytest.mark.parametrize("pipeline", ["label", "feat"])
def test_dropout_mask_comes_from_the_generator(pipeline):
    """Training at dropout_rate 0.5: one draw per backbone pass, on the
    stacked (2B, N, out_feat_dim) features, from the caller's generator, so
    a seed reproduces the pass and another seed changes it; inference draws
    nothing."""
    jcfg, _ = configs(pipeline, {})
    arrays = synthetic_arrays(jcfg)
    cfg = ModelConfig(**dict(MODEL, dropout_rate=0.5))
    model = Network(cfg, pipeline)
    model.load_state_dict(init_params(cfg, seed=3, pipeline=pipeline))
    batch = device_batch(cfg, arrays, device="cpu")
    calls = []
    real = RandLA.dropout

    def spy(self, feat, generator, *rest):
        out = real(self, feat, generator, *rest)
        calls.append((tuple(feat.shape), out == 0))
        return out
    with mock.patch.object(RandLA, "dropout", spy):
        runs = [model.forward_pair(batch, train=True, generator=torch.Generator().manual_seed(s))
                for s in (5, 5, 6)]
        assert [c[0] for c in calls] == [(4, MODEL["num_points"], MODEL["out_feat_dim"])] * 3
        assert torch.equal(calls[0][1], calls[1][1]) and not torch.equal(calls[0][1], calls[2][1])
        share = float(calls[0][1].float().mean())
        assert 0.45 < share < 0.55
        forward_step(model, cfg, arrays)
        assert len(calls) == 3
    assert torch.equal(runs[0].logits_src, runs[1].logits_src)
    assert not torch.equal(runs[0].logits_src, runs[2].logits_src)
    field = "score_src" if pipeline == "feat" else "feat_src"
    assert torch.equal(getattr(runs[0], field), getattr(runs[1], field))
