"""The port's align training step (`deepsir_tpu_torch.training.train_step`)
against the JAX package's, on the CPU at the size of tests/test_training.py
(256 points, d_out (8, 16)), with dropout_rate 0 so that both compute the
same function.

One JAX step is `jax.value_and_grad(compute_loss)` followed by the
optimizer's `tx.update` (deepsir_tpu/training.py), over the port's own
pyramids (JAX's CPU KNN orders near ties by the norm expansion). Cases: the
default options; the flagship channels with the relaxed mutual gate (F +
gate); `absolute_pose_solve`; the mse distance with a pose term. Three
steps each, with a schedule that decays at every step and reaches its floor.

Tolerances: loss terms 1e-5 relative; every inlier grad leaf 1e-4 relative
to the leaf's largest magnitude; params after 3 steps 1e-5 absolute; lr
1e-7 absolute; held only while every iteration's matches equal JAX's
(asserted). At this width four biases are blind: each feeds a GroupNorm
with one channel per group, which subtracts it exactly, so its gradient is
zero but for rounding (in both packages below 1e-6 of the net's largest
grad, asserted), and Adam turns that noise into steps of about lr in either
direction; those four are held to the noise bound and left out of the
params comparison. Also: the schedule against optax, the skip guard, the
freeze and the dropout draw.
"""
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
from deepsir_tpu.models import ForwardOptions as JaxForwardOptions, Network as JaxNetwork
from deepsir_tpu.models.network import PairBatch as JaxPairBatch
from deepsir_tpu.ops.pyramid import Pyramid as JaxPyramid
from deepsir_tpu.training import (batch_arrays_only, compute_loss as jax_compute_loss,
                                  make_lr_schedule, make_optimizer as jax_make_optimizer)
from deepsir_tpu_torch.config import LossConfig, ModelConfig, RunConfig, TrainConfig
from deepsir_tpu_torch.models.layers import ConvUnit
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.training import (adam_count, device_batch, lr_at, make_optimizer,
                                        train_step)
from deepsir_tpu_torch.utils.params import flax_path, init_params, to_jax_params

MODEL = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4),
             d_out=(8, 16), out_feat_dim=16, num_train_reg_iter=2, num_reg_iter=2,
             dropout_rate=0.0)
# lr 1e-3, halved at every applied update, floored at 3e-4 from step 3 on
TRAIN = dict(lr=1e-3, lr_decay_epoch=1, lr_decay_ratio=0.5, lr_clip=3e-4)
STEPS_PER_EPOCH = 1
STEPS = 3
FLAGSHIP = dict(inlier_extra_feats="dist,recip", clip_weight_thresh=0.05,
                mutual_check=True, mutual_check_tol=0.6)
CASES = {
    "default": ({}, {}),
    "F+gate": (FLAGSHIP, {}),
    "absolute_pose_solve": (dict(absolute_pose_solve=True), {}),
    "mse+pose": ({}, dict(loss_type="mse", wt_pose_loss=0.5)),
}


def configs(model_kw, loss_kw):
    model = dict(MODEL, **model_kw)
    jcfg = Config(pipeline="align", model=JaxModelConfig(**model),
                  data=DataConfig(dataset_type="Synthetic"),
                  loss=JaxLossConfig(**loss_kw), train=JaxTrainConfig(**TRAIN)).resolved()
    cfgs = RunConfig(ModelConfig(**model),
                     LossConfig(**loss_kw, thres_radius=jcfg.loss.thres_radius),
                     TrainConfig(**TRAIN))
    return jcfg, cfgs


def arrays_for(jcfg, n=2):
    ds = SyntheticPairs(jcfg, "train", size=n)
    batch = batch_arrays_only(next(iter(Loader(ds, batch_size=n, shuffle=False,
                                                num_workers=1))))
    return {k: batch[k] for k in ("points_src", "points_ref", "transform_gt")}


def jax_pyramid(pyr):
    return JaxPyramid(*(tuple(jnp.asarray(a.numpy().astype(np.float32 if k == "xyz" else
                                                          np.int32)) for a in field)
                        for k, field in pyr._asdict().items()))


def leaf(tree, key):
    """The flax leaf of port parameter `key` in the port's layout."""
    path, transpose = flax_path(key)
    tree = tree["params"]
    for p in path:
        tree = tree[p]
    arr = np.asarray(tree)
    return arr.T if transpose else arr


def run_jax(jcfg, params, arrays, pyramids, steps):
    """`steps` JAX steps: per step the loss terms, the inlier grads, the
    matches and `invalid`; and the params after the last."""
    model = JaxNetwork(jcfg.model, pipeline="align")
    opts = JaxForwardOptions(num_iter=jcfg.model.num_train_reg_iter)
    batch = JaxPairBatch(jnp.asarray(arrays["points_src"]), jnp.asarray(arrays["points_ref"]),
                         *pyramids, jnp.asarray(arrays["transform_gt"]))
    rng = jax.random.PRNGKey(0)

    @jax.jit
    def grads_of(p):
        (loss, aux), g = jax.value_and_grad(
            lambda q: jax_compute_loss(jcfg, model, q, batch, opts, True, rng),
            has_aux=True)(p)
        _, out = model.apply(p, batch, opts, train=True, rngs={"dropout": rng})
        return loss, aux, g, out.pred_idx

    tx = jax_make_optimizer(jcfg, STEPS_PER_EPOCH)
    opt_state = tx.init(params)
    record = []
    for _ in range(steps):
        loss, aux, g, pred = jax.device_get(grads_of(params))
        record.append({"loss": float(loss), "losses": aux["losses"], "grads": g,
                       "pred_idx": np.asarray(pred), "invalid": bool(aux["invalid"])})
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    return record, jax.device_get(params)


def blind_biases(model):
    """The inlier net's biases that feed a GroupNorm of one channel per group."""
    return {f"inlier_model.{name}.dense.bias" for name, m in model.inlier_model.named_modules()
            if isinstance(m, ConvUnit) and m.norm is not None
            and m.norm.groups == m.dense.out_features}


@pytest.fixture(scope="module")
def runs():
    return {}


def _case(runs, name):
    if name not in runs:
        model_kw, loss_kw = CASES[name]
        jcfg, cfgs = configs(model_kw, loss_kw)
        arrays = arrays_for(jcfg)
        state = init_params(cfgs.model, seed=3)
        pyr = device_batch(cfgs.model, arrays, device="cpu")
        want, want_params = run_jax(jcfg, {"params": to_jax_params(state)["params"]}, arrays,
                                    (jax_pyramid(pyr.pyramid_src),
                                     jax_pyramid(pyr.pyramid_ref)), STEPS)
        model = Network(cfgs.model)
        model.load_state_dict(state)
        opt = make_optimizer(model)
        gen = torch.Generator().manual_seed(0)
        got = [train_step(model, opt, cfgs, arrays, gen, STEPS_PER_EPOCH)
               for _ in range(STEPS)]
        # the grads of each step, before the next step replaces them
        runs[name] = (cfgs, state, model, opt, got, want, want_params)
    return runs[name]


@pytest.mark.parametrize("name", list(CASES))
def test_loss_terms_and_matches_equal_jax(runs, name):
    _, _, _, _, got, want, _ = _case(runs, name)
    for step, (g, w) in enumerate(zip(got, want)):
        # held only while the matches agree: they do, in every iteration
        np.testing.assert_array_equal(g["pred_idx"].numpy(), w["pred_idx"],
                                      err_msg=f"step {step}")
        assert not g["skipped"] and not w["invalid"] and not bool(g["invalid"])
        assert set(g["losses"]) == set(w["losses"])
        for key, value in w["losses"].items():
            np.testing.assert_allclose(float(g["losses"][key]), float(value), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {step} {key}")
        np.testing.assert_allclose(float(g["loss"]), w["loss"], rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_every_inlier_grad_leaf_equals_jax(runs, name):
    _, _, model, _, got, want, _ = _case(runs, name)
    blind = blind_biases(model)
    assert len(blind) == 4
    for step, (g, w) in enumerate(zip(got, want)):
        assert len(g["grads"]) == len(list(model.inlier_model.parameters()))
        refs = {n: leaf(w["grads"], n) for n in g["grads"]}
        largest = max(float(np.abs(r).max()) for r in refs.values())
        for pname, grad in g["grads"].items():
            ref = refs[pname]
            if pname in blind:
                assert max(float(grad.abs().max()), float(np.abs(ref).max())) <= 1e-6 * largest
                continue
            scale = float(np.abs(ref).max())
            err = float(np.abs(grad.numpy() - ref).max())
            assert err <= 1e-4 * scale, (step, pname, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_params_after_three_steps_equal_jax_and_frozen_stay(runs, name):
    _, state, model, opt, got, _, want_params = _case(runs, name)
    assert adam_count(opt) == STEPS
    assert any(not torch.equal(v, state[k]) for k, v in model.state_dict().items()
               if k.startswith("inlier_model."))
    assert [g["lr"] for g in got] == [lr_at(i, TrainConfig(**TRAIN), 1) for i in range(STEPS)]
    blind = blind_biases(model)
    for key, value in model.state_dict().items():
        if key in blind:
            continue
        if key.startswith("inlier_model."):
            np.testing.assert_allclose(value.numpy(), leaf(want_params, key), rtol=0,
                                       atol=1e-5, err_msg=key)
        else:                                        # frozen: bit-identical
            assert torch.equal(value, state[key]), key


@pytest.mark.parametrize("count", [0, 1, 3, 4, 5, 7, 8, 9, 63, 64, 65, 100000])
@pytest.mark.parametrize("steps_per_epoch", [1, 16])
def test_lr_at_equals_optax(count, steps_per_epoch):
    train = JaxTrainConfig()                        # 1e-3, x0.98 every 4 epochs, floor 1e-4
    sched = make_lr_schedule(Config(pipeline="align", train=train), steps_per_epoch)
    got = lr_at(count, TrainConfig(), steps_per_epoch)
    assert abs(got - float(sched(jnp.asarray(count, jnp.int32)))) <= 1e-7
    staged = JaxTrainConfig(**TRAIN)
    sched = make_lr_schedule(Config(pipeline="align", train=staged), steps_per_epoch)
    assert abs(lr_at(count, TrainConfig(**TRAIN), steps_per_epoch)
               - float(sched(jnp.asarray(count, jnp.int32)))) <= 1e-7


def test_skip_guard_leaves_params_moments_and_count():
    jcfg, cfgs = configs({}, {})
    arrays = arrays_for(jcfg)
    model = Network(cfgs.model)
    model.load_state_dict(init_params(cfgs.model, seed=3))
    opt = make_optimizer(model)
    gen = torch.Generator().manual_seed(0)
    assert not train_step(model, opt, cfgs, arrays, gen, 1)["skipped"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()} for p, s in opt.state.items()}
    bad = dict(arrays, points_src=arrays["points_src"].copy())
    bad["points_src"][0, 5, 0] = np.nan                 # a NaN point poisons the step
    out = train_step(model, opt, cfgs, bad, gen, 1)
    assert out["skipped"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in opt.state.items():
        for k, v in s.items():
            assert torch.equal(v, moments[id(p)][k]), k
    assert adam_count(opt) == 1
    # and the next good step proceeds from the unchanged count
    assert not train_step(model, opt, cfgs, arrays, gen, 1)["skipped"]
    assert adam_count(opt) == 2


def test_optimizer_holds_only_the_inlier_params():
    model = Network(ModelConfig(**MODEL))
    held = {id(p) for g in make_optimizer(model).param_groups for p in g["params"]}
    assert held == {id(p) for p in model.inlier_model.parameters()}


def test_dropout_draw_is_seeded_kept_at_rate_and_scaled():
    cfg = ModelConfig(**dict(MODEL, dropout_rate=0.25))
    net = Network(cfg).inlier_model
    feat = torch.rand(2, 4096, 16) + 0.5
    a = net.dropout(feat, torch.Generator().manual_seed(7))
    b = net.dropout(feat, torch.Generator().manual_seed(7))
    c = net.dropout(feat, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    # 131072 draws: the kept share is 0.75 within 5 standard deviations
    assert abs(float(kept.float().mean()) - 0.75) < 5 * (0.75 * 0.25 / kept.numel()) ** 0.5
    torch.testing.assert_close(a[kept], feat[kept] / 0.75, rtol=0, atol=0)
    # rate 0 is the identity, as flax's Dropout
    assert Network(ModelConfig(**MODEL)).inlier_model.dropout(feat, None) is feat


def test_the_jax_train_fixture_reproduces_on_the_cpu():
    """tests/data/torch_parity_train.npz (two JAX steps of the staged align
    checkpoint, resumed at count 1760, 1024 points, 2 pairs) against the
    port's `train_step` through chip_smoke.train_parity, with no JAX at run
    time: loss terms 1e-5 relative, step-1 inlier grads and the params after
    step 2 5e-4 of each leaf's scale (whole leaves by max-abs, summarised
    ones by their top entries, norm and projections), every iteration's
    matches equal. The grads' worst leaf, 1.7e-4, is the LocSE branch of
    the inlier net's first level (enc_0/lfa/mlp1), whose inputs carry raw
    coordinates and whose gradient sums 32768 terms with cancellation."""
    import chip_smoke
    _, rec = chip_smoke.train_parity(torch, "cpu", terms_rtol=1e-5, leaf_rtol=5e-4)
    assert rec["resumed_count"] == 1760 and rec["all_held"], rec
    assert [s["skipped"] for s in rec["steps"]] == [False, False]
    assert rec["param_rel_err"] <= 5e-4


def test_dropout_draws_a_fresh_mask_each_iteration_in_the_inlier_net_only():
    """Training at dropout_rate 0.5: the inlier net's dropout runs once per
    registration iteration, on (B, N, out_feat_dim), each time with a new
    mask from the caller's generator; the backbone runs without dropout,
    and inference draws nothing."""
    from unittest import mock
    from deepsir_tpu_torch.models.randla import RandLA
    cfg = ModelConfig(**dict(MODEL, dropout_rate=0.5))
    jcfg, _ = configs({}, {})
    arrays = arrays_for(jcfg)
    model = Network(cfg)
    model.load_state_dict(init_params(cfg, seed=3))
    batch = device_batch(cfg, arrays, device="cpu")
    calls = []
    real = RandLA.dropout

    def spy(self, feat, generator, *rest):
        out = real(self, feat, generator, *rest)
        calls.append((self is model.inlier_model, tuple(feat.shape), out == 0))
        return out
    from deepsir_tpu_torch.models.network import ForwardOptions
    with mock.patch.object(RandLA, "dropout", spy):
        model.forward_align(batch, ForwardOptions(num_iter=2), train=True,
                            generator=torch.Generator().manual_seed(0))
        assert len(calls) == 2 and all(c[0] for c in calls)
        assert calls[0][1] == calls[1][1] == (2, 256, cfg.out_feat_dim)
        assert not torch.equal(calls[0][2], calls[1][2])
        model.forward_align(batch, ForwardOptions(num_iter=2))
        assert len(calls) == 2
