"""bf16 compute in the port (`compute_dtype`, `inlier_compute_dtype` =
"bfloat16") against the JAX package, on the CPU.

The references are JAX's jitted forwards and steps with XLA's excess
precision off (tests/data/make_torch_parity_fixture.py: XLA_BF16), so that
every bf16 op rounds as flax's bf16 `Dense` defines it (with it on, XLA's
CPU compiler drops the rounding of a Dense output in one fusion and keeps
it in its twin); under bf16 compute JAX's search runs through the
`matcher` hook `bf16_matcher` (JAX's CPU search ignores `low_precision`),
which is held here against the interpreted Pallas kernel.

Gates. A Dense layer is bit-equal to flax's but for entries at a bf16
rounding boundary (at most 0.1%, each within one bf16 ulp of the product
plus one of the output). Every other bf16 gate follows the discriminating
rule: a statistic of |port - JAX bf16| is at most `k` times the same
statistic of |JAX bf16 - JAX fp32| on the same input (a port that silently
computed fp32 sits at ~1). bf16 rounding amplifies any fp32 difference of
summation order: a GroupNorm's statistics differ in their last bit, a
later Dense input crosses a bf16 rounding boundary, and over the levels of
a deep net the flips spread. So:
- one layer, the 2-level nets at 256 points: k = 1/4 on the median;
- the staged checkpoint (4 levels) at 1024 points
  (tests/data/torch_parity_precision.npz): k = 3/4 on the median of the
  descriptors and iteration-1 inlier logits (measured 0.46-0.48), on the
  share of iteration-1 matches that differ (0.61) and on the bf16 step's
  loss (0.17); success flags equal on every pair; registered pairs' final
  transforms within 0.1 of JAX's bf16 ones (measured up to 0.0525, where
  JAX's own bf16 and fp32 poses are 0.008-0.03 apart). ROADMAP.md Queue 3
  records these allowances.
- inlier-only bf16: the descriptors and the iteration-1 matches are
  bit-identical to the port's fp32 run (as tests/test_model.py says of
  JAX); the inlier logits k = 1/4; registered pairs' final transforms
  within 1e-2 of JAX's (measured 1.4e-3).
- the training steps at 256 points: loss terms k = 1/4, each trained
  leaf's grad k = 1/2 (measured 0.25), the grads of Dense biases as
  `_assert_grads` says.
The staged checkpoint's gates live in chip_smoke.py (precision_parity,
precision_step_parity), which runs them on the card too.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import test_torch_match_lp as L
import test_torch_pipelines as P
import test_torch_train as T
from deepsir_tpu.models import ForwardOptions as JaxForwardOptions, Network as JaxNetwork
from deepsir_tpu.models.layers import MLP as JaxMLP, AttPooling as JaxAttPooling
from deepsir_tpu.models.layers import ConvUnit as JaxConvUnit
from deepsir_tpu.models.network import PairBatch as JaxPairBatch
from deepsir_tpu.models.randla import RandLA as JaxRandLA
from deepsir_tpu.ops.pallas_match import match_argmin_bidirectional as pallas_bidir
from deepsir_tpu.ops.pallas_match import match_argmin_single
from deepsir_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from deepsir_tpu.training import compute_loss as jax_compute_loss
from deepsir_tpu_torch.config import ModelConfig, replace
from deepsir_tpu_torch.models.layers import MLP, AttPooling, ConvUnit, dense
from deepsir_tpu_torch.models.network import ForwardOptions, Network
from deepsir_tpu_torch.models.randla import RandLA
from deepsir_tpu_torch.ops.cuda_match import match_argmin_plain
from deepsir_tpu_torch.ops.pyramid import Pyramid
from deepsir_tpu_torch.training import device_batch, make_optimizer, train_step
from deepsir_tpu_torch.utils.params import from_jax_params, init_params, to_jax_params

_spec = importlib.util.spec_from_file_location(
    "make_torch_parity_fixture", Path(__file__).parent / "data" / "make_torch_parity_fixture.py")
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)

BF16 = torch.bfloat16
QUARTER, THREE_QUARTERS = 0.25, 0.75


def _jit(fn):
    return jax.jit(fn, compiler_options=F.XLA_BF16)


def _median(a):
    return float(np.median(np.abs(np.asarray(a, np.float64))))


def assert_discriminating(got, want, want_fp32, k, what):
    """median |got - want| <= k * median |want - want_fp32|, and the gap is
    real (JAX's bf16 and fp32 outputs differ)."""
    err, gap = _median(np.asarray(got) - want), _median(np.asarray(want) - want_fp32)
    assert gap > 0, (what, "JAX's bf16 and fp32 outputs are equal")
    assert err <= k * gap, (what, err, gap)
    return err, gap


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _flax_params(module, x, rng, seed=0):
    params = module.init(jax.random.PRNGKey(seed), x)["params"]
    # non-trivial affine and biases
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)


def _load(module, params):
    module.load_state_dict(from_jax_params(jax.device_get(params), module), strict=True)
    return module.eval()


# ------------------------------------------------------------- the search hook

@pytest.mark.parametrize("n,m,c", [(300, 700, 64), (129, 257, 16)])
def test_bf16_matcher_hook_matches_pallas_interpret(rng, n, m, c):
    """The fixtures' bf16 search hook against the interpreted Pallas kernel
    with low_precision=True, and against the port's plain bf16 form, both
    ways: equal but for near ties of the bf16 form's own distance."""
    src = rng.normal(size=(n, c)).astype(np.float32)
    ref = rng.normal(size=(m, c)).astype(np.float32)
    hook = np.asarray(F.bf16_matcher(src[None], ref[None]))[0]
    back = np.asarray(F.bf16_matcher(ref[None], src[None]))[0]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(match_argmin_single(src, ref, low_precision=True))
        _, wridx = pallas_bidir(src, ref, low_precision=True)
    d = L._lp_dist(src, ref)
    L._near_ties(hook, want, d)
    L._near_ties(back, np.asarray(wridx), d.T)
    port = match_argmin_plain(torch.from_numpy(src)[None], torch.from_numpy(ref)[None],
                              low_precision=True)[0].numpy()
    L._near_ties(port, hook, d)


# ---------------------------------------------------------------- the layers

@pytest.mark.parametrize("c_in,c_out,bias", [(10, 8, True), (64, 128, True), (512, 256, True),
                                             (64, 64, False)])
def test_dense_rounds_as_flax(rng, c_in, c_out, bias):
    """`dense` against flax's bf16 Dense (mlp_out: no bias): bit-equal but
    for entries at a bf16 rounding boundary, each within one bf16 ulp of the
    product plus one of the output; the fp32 Dense differs almost
    everywhere."""
    x = rng.normal(size=(4096, c_in)).astype(np.float32)
    jm = fnn.Dense(c_out, use_bias=bias, dtype=jnp.bfloat16)
    params = _flax_params(jm, x, rng)
    want = np.asarray(_jit(lambda p, x: jm.apply({"params": p}, x))(params, x)
                      .astype(jnp.float32))
    layer = torch.nn.Linear(c_in, c_out, bias=bias)
    layer.weight.data = torch.from_numpy(np.ascontiguousarray(params["kernel"].T))
    if bias:
        layer.bias.data = torch.from_numpy(params["bias"])
    with torch.no_grad():
        got = dense(layer, torch.from_numpy(x), BF16)
        fp32 = dense(layer, torch.from_numpy(x), None).numpy()
    assert got.dtype == BF16
    got = got.float().numpy()
    bad = got != want
    assert bad.mean() <= 1e-3, bad.mean()
    xb, wb = (torch.from_numpy(a).to(BF16).double().numpy() for a in (x, params["kernel"]))
    product = (xb @ wb)[bad]
    assert (np.abs(got - want)[bad] <= _bf16_ulp(product) + _bf16_ulp(want[bad])).all()
    assert (fp32 != want).mean() > 0.9


def _unit_cases():
    return {
        "ConvUnit-group": (lambda: JaxConvUnit(128, dtype=jnp.bfloat16),
                           lambda: ConvUnit(64, 128, dtype=BF16), (2, 2048, 64)),
        "ConvUnit-batch": (lambda: JaxConvUnit(32, norm="batch", dtype=jnp.bfloat16),
                           lambda: ConvUnit(16, 32, norm="batch", dtype=BF16), (2, 2048, 16)),
        "ConvUnit-none": (lambda: JaxConvUnit(32, norm="none", dtype=jnp.bfloat16),
                          lambda: ConvUnit(16, 32, norm="none", dtype=BF16), (2, 2048, 16)),
        "MLP": (lambda: JaxMLP((64, 32, 19), dtype=jnp.bfloat16),
                lambda: MLP(64, (64, 32, 19), dtype=BF16), (2, 2048, 64)),
        "AttPooling": (lambda: JaxAttPooling(64, dtype=jnp.bfloat16),
                       lambda: AttPooling(32, 64, dtype=BF16), (2, 500, 16, 32)),
    }


@pytest.mark.parametrize("name", list(_unit_cases()))
def test_units_match_flax_bf16(rng, name):
    """ConvUnit (each norm), MLP and AttPooling in bf16 against flax's:
    fp32 outputs, the median rule at k = 1/4 (the median error is 0 or at
    GroupNorm's fp32 rounding, the gap ~1e-2), and no entry off by more than
    one bf16 ulp of the output's largest magnitude."""
    make_jax, make_port, shape = _unit_cases()[name]
    x = rng.normal(size=shape).astype(np.float32)
    jm = make_jax()
    params = _flax_params(jm, x, rng)
    want = np.asarray(_jit(lambda p, x: jm.apply({"params": p}, x))(params, x))
    jm32 = jm.clone(dtype=None)
    want32 = np.asarray(jax.jit(lambda p, x: jm32.apply({"params": p}, x))(params, x))
    with torch.no_grad():
        got = _load(make_port(), params)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    assert_discriminating(got, want, want32, QUARTER, name)
    assert np.abs(got - want).max() <= _bf16_ulp(np.abs(want).max())


# -------------------------------------------------------------- the backbone

TINY = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4), d_out=(8, 16),
            out_feat_dim=16, num_classes=5, compute_dtype="bfloat16")


@pytest.mark.parametrize("ppf,k", [(False, QUARTER), (True, THREE_QUARTERS)])
def test_randla_bf16_matches_flax(rng, ppf, k):
    """A 2-level RandLA in bf16 against flax's: features and logits by the
    median rule at k = 1/4; on point-pair features at k = 3/4 (measured
    0.75 of the logits' gap, 3.9e-3 against 5.2e-3: the angles agree with
    JAX's to 2.4e-7, and those last bits flip bf16 roundings of the first
    Dense's input, which the 2 levels spread). The LocSE cache gives the
    same outputs; the outputs and the parameters are fp32."""
    from deepsir_tpu.config import ModelConfig as JaxModelConfig
    opts = dict(TINY, use_ppf=ppf, feat_len=6 if ppf else 3)
    pts = rng.normal(size=(2, 256, 3)).astype(np.float32)
    feats = pts if not ppf else np.concatenate(
        [pts, (lambda n: n / np.linalg.norm(n, axis=-1, keepdims=True))(
            rng.normal(size=(2, 256, 3))).astype(np.float32)], axis=-1)
    jpyr = jax_build_pyramid(pts, num_knn=8, ratios=(4, 4), recall_target=1.0)
    tpyr = Pyramid(*(tuple(torch.tensor(np.asarray(a)).to(
        torch.float32 if a.dtype == np.float32 else torch.int64) for a in field)
        for field in jpyr))
    jm = JaxRandLA(JaxModelConfig(**opts), num_classes=5)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), feats, jpyr)["params"]
    want = _jit(lambda p, f, y: jm.apply({"params": p}, f, y))(params, feats, jpyr)
    jm32 = JaxRandLA(JaxModelConfig(**dict(opts, compute_dtype="float32")), num_classes=5)
    want32 = jax.jit(lambda p, f, y: jm32.apply({"params": p}, f, y))(params, feats, jpyr)
    model = _load(RandLA(ModelConfig(**opts), 5, opts["feat_len"]), params)
    with torch.no_grad():
        got = model(torch.from_numpy(feats), tpyr)
        cached = model(torch.from_numpy(feats), tpyr, pos_cache=model.pos_cache(tpyr))
    for what, g, w, w32, c in zip(("feat", "logits"), got, want, want32, cached):
        assert g.dtype == torch.float32
        assert_discriminating(g.numpy(), np.asarray(w), np.asarray(w32), k, what)
        assert torch.equal(g, c), what
    assert {p.dtype for p in model.parameters()} == {torch.float32}


# -------------------------------------------------- the align forward, small

SMALL = dict(T.MODEL, num_reg_iter=3)
SMALL_PATHS = {"B16": dict(compute_dtype="bfloat16"),
               "B16F": dict(compute_dtype="bfloat16", inlier_extra_feats="dist,recip",
                            clip_weight_thresh=0.05),
               "I16": dict(inlier_compute_dtype="bfloat16")}


def _jax_descriptors(mdl, batch):
    fs, ls, fr, lr, _, _ = mdl.backbone_pair(batch, train=False)
    ss, sr = mdl.score_pair(batch, fs, fr, ls, lr)
    return (mdl.aggregate_side(batch.points_src[..., :3], fs, ss),
            mdl.aggregate_side(batch.points_ref[..., :3], fr, sr))


def _port_descriptors(net, batch):
    with torch.no_grad():
        fs, ls, fr, lr = net.backbone_pair(batch)
        ss, sr = net.score_pair(batch, fs, fr, ls, lr)
        return (net.aggregate_side(batch.points_src[..., :3], fs, ss),
                net.aggregate_side(batch.points_ref[..., :3], fr, sr))


def _jax_align(jcfg, params, arrays, batch, bf16_search):
    """JAX's forward (clip_weight) and iteration-1 descriptors over the
    port's pyramids."""
    net = JaxNetwork(jcfg.model, pipeline="align",
                     matcher=F.bf16_matcher if bf16_search else None)
    opts = JaxForwardOptions(num_iter=jcfg.model.num_reg_iter, clip_weight=True)
    jbatch = JaxPairBatch(jnp.asarray(arrays["points_src"]), jnp.asarray(arrays["points_ref"]),
                          T.jax_pyramid(batch.pyramid_src), T.jax_pyramid(batch.pyramid_ref),
                          jnp.asarray(arrays["transform_gt"]))

    def run(p, b):
        _, out = net.apply(p, b, opts, train=False)
        return out, net.apply(p, b, method=_jax_descriptors)
    return jax.device_get(_jit(run)(params, jbatch))


@pytest.fixture(scope="module")
def small_runs():
    return {}


def _small(small_runs, name):
    if name not in small_runs:
        options = SMALL_PATHS[name]
        fp32 = {k: v for k, v in options.items() if "dtype" not in k}
        jcfg, cfgs = T.configs(dict(SMALL, **options), {})
        jcfg32, _ = T.configs(dict(SMALL, **fp32), {})
        arrays = T.arrays_for(jcfg)
        state = init_params(cfgs.model, seed=4)
        model = Network(cfgs.model)
        model.load_state_dict(state)
        batch = device_batch(cfgs.model, arrays, device="cpu")
        out = model.forward_align(batch, ForwardOptions(num_iter=SMALL["num_reg_iter"],
                                                        clip_weight=True))
        params = to_jax_params(state)
        bf16 = options.get("compute_dtype") == "bfloat16"
        small_runs[name] = (cfgs, model, batch, out, _port_descriptors(model, batch),
                            _jax_align(jcfg, params, arrays, batch, bf16),
                            _jax_align(jcfg32, params, arrays, batch, False))
    return small_runs[name]


@pytest.mark.parametrize("name", ["B16", "B16F"])
def test_forward_align_bf16_matches_jax(small_runs, name):
    """compute_dtype bf16 at 256 points: iteration-1 descriptors and inlier
    logits by the median rule at k = 1/4; iteration-1 matches equal but for
    near ties of the bf16 form's distance over the port's descriptors (the
    share of differing rows by the rule at k = 1/4, each within 2^-8 of the
    distance's terms |s|^2 + |r|^2 (measured 1.5e-3): the two packages'
    descriptors differ in their last bf16 bits); transforms within
    1e-3 up to each pair's first iteration whose matches differ; `invalid`
    equal."""
    cfgs, model, batch, out, (ds, dr), (jout, (jds, jdr)), (j32, (jds32, jdr32)) = \
        _small(small_runs, name)
    assert model.low_precision
    assert_discriminating(ds.numpy(), jds, jds32, QUARTER, "src descriptors")
    assert_discriminating(dr.numpy(), jdr, jdr32, QUARTER, "ref descriptors")
    pred, want = out.pred_idx.numpy(), np.asarray(jout.pred_idx).astype(np.int64)
    differ = pred[0] != want[0]
    gap = (want[0] != np.asarray(j32.pred_idx[0])).mean()     # 10.7%
    assert differ.mean() <= QUARTER * gap, (differ.mean(), gap)   # 1.4%
    if differ.any():
        q, r = ds.double(), dr.double()
        qb, rb = ds.to(BF16).double(), dr.to(BF16).double()

        def dist(idx):
            rows = torch.gather(rb, 1, torch.from_numpy(idx)[..., None].expand(qb.shape))
            sq = torch.gather((r * r).sum(-1), 1, torch.from_numpy(idx))
            return ((q * q).sum(-1) + sq - 2.0 * (qb * rows).sum(-1)).numpy()
        scale = (q * q).sum(-1).numpy() + 1.0
        assert (np.abs(dist(pred[0]) - dist(want[0]))[differ] <= 2 ** -8 * scale[differ]).all()
    same = ~differ
    assert_discriminating(out.inlier_logits[0].numpy()[same], np.asarray(jout.inlier_logits[0])[same],
                          np.asarray(j32.inlier_logits[0])[same], QUARTER, "logits")
    held = chip_smoke.held_iterations(pred, want, np.ones(pred.shape[:2]))
    err = np.abs(out.transforms.numpy() - np.asarray(jout.transforms)).max(axis=(2, 3))
    for b, n in enumerate(held):
        assert (err[:n, b] <= 1e-3).all(), (b, n, err[:, b])
    np.testing.assert_array_equal(out.invalid.numpy(), np.asarray(jout.invalid))


def test_forward_align_inlier_bf16(small_runs):
    """inlier_compute_dtype bf16 alone: descriptors and matches up to the
    first differing iteration bit-identical to the port's fp32 forward, the
    search in its fp32-grade form; the inlier logits by the median rule at
    k = 1/4 against JAX's inlier-bf16 run."""
    cfgs, model, batch, out, (ds, dr), (jout, _), (j32, _) = _small(small_runs, "I16")
    assert not model.low_precision
    fp32 = Network(replace(cfgs.model, inlier_compute_dtype="float32"))
    fp32.load_state_dict(model.state_dict())
    out32 = fp32.forward_align(batch, ForwardOptions(num_iter=SMALL["num_reg_iter"],
                                                     clip_weight=True))
    ds32, dr32 = _port_descriptors(fp32, batch)
    assert torch.equal(ds, ds32) and torch.equal(dr, dr32)
    assert torch.equal(out.pred_idx[0], out32.pred_idx[0])
    n = chip_smoke._held(out.pred_idx.numpy(), out32.pred_idx.numpy())
    assert n >= 1
    assert_discriminating(out.inlier_logits[0].numpy(), np.asarray(jout.inlier_logits[0]),
                          np.asarray(j32.inlier_logits[0]), QUARTER, "inlier logits")


# --------------------------------------- the staged checkpoint at 1024 points

@pytest.fixture(scope="module")
def ckpt_record():
    """chip_smoke.precision_parity on the CPU: the staged checkpoint on the
    checkpoint fixture's 8 pairs at 1024 points under B16, B16F, I16 and
    fp32 against tests/data/torch_parity_precision.npz (it raises on a
    broken gate; its record holds what was measured)."""
    return chip_smoke.precision_parity(torch, torch.device("cpu"))[2]


@pytest.mark.parametrize("name", ["B16", "B16F"])
def test_checkpoint_bf16_matches_jax(ckpt_record, name):
    """Under bf16 compute (B16F: the dist,recip channels on the fixture's
    widened inlier layer), against JAX's bf16 forward with the search hook:
    descriptors, iteration-1 inlier logits and the share of differing
    iteration-1 matches by the rule at k = 3/4 (measured 0.46-0.48 and
    0.61); success flags equal on all 8 pairs, both outcomes occurring;
    transforms within 1e-3 up to each pair's first iteration whose matches
    differ or whose solve is ill-conditioned; registered pairs' final
    transforms within 0.1 (measured up to 0.0525, B16F's pair 3, where JAX's
    own bf16 and fp32 poses are 0.022 apart)."""
    rec = ckpt_record[name]
    for key in ("desc_src", "desc_ref", "logits1"):
        assert rec[key]["k"] == chip_smoke.DEEP_K
        assert rec[key]["median_err"] <= chip_smoke.DEEP_K * rec[key]["median_gap"]
    assert any(rec["success"]) and not all(rec["success"])
    assert rec["held_transform_err"] <= 1e-3 and rec["registered_final_err"] <= 0.1


def test_checkpoint_inlier_bf16(ckpt_record):
    """A bf16 inlier net only: descriptors and iteration-1 matches equal to
    the port's fp32 forward bit for bit (chip_smoke.precision_parity raises
    otherwise); the iteration-1 logits by the rule at k = 1/4 against JAX's
    inlier-bf16 forward (measured: median error 0, gap 0.023); success flags
    equal; registered pairs' final transforms within 1e-2 (measured 1.4e-3,
    on the card 2.7e-3; JAX's own inlier-bf16 and fp32 poses of those pairs
    are 1.2e-3 to 2.2e-3 apart): the bf16 inlier weights move each pose."""
    rec = ckpt_record["I16"]
    assert rec["logits1"]["k"] == chip_smoke.SHALLOW_K
    assert rec["registered_final_err"] <= 1e-2


def test_checkpoint_bf16_step():
    """chip_smoke.precision_step_parity on the CPU: one align step of the
    staged checkpoint resumed with its Adam state, both compute dtypes bf16,
    on the train fixture's 2 pairs at 1024 points: the total loss and the
    share of differing iteration-1 matches by the rule at k = 3/4 against
    JAX's bf16 step (JAX's bf16 and fp32 losses 1.797 and 2.385; measured
    0.17 and 0.61 of the gaps), applied, params and Adam's moments fp32."""
    rec = chip_smoke.precision_step_parity(torch, torch.device("cpu"))
    assert not rec["skipped"]
    assert abs(rec["loss"] - rec["jax_bf16_loss"]) <= \
        chip_smoke.DEEP_K * abs(rec["jax_bf16_loss"] - rec["jax_fp32_loss"])


# ---------------------------------------------------------- the training steps

def _jax_grads(jcfg, params, batch, bf16_search, pipeline="align"):
    model = JaxNetwork(jcfg.model, pipeline=pipeline,
                       matcher=F.bf16_matcher if bf16_search else None)
    opts = JaxForwardOptions(num_iter=jcfg.model.num_train_reg_iter)
    rng = jax.random.PRNGKey(0)

    def step(p):
        (loss, aux), g = jax.value_and_grad(
            lambda q: jax_compute_loss(jcfg, model, q, batch, opts, True, rng), has_aux=True)(p)
        if pipeline != "align":
            return loss, aux, g, None
        _, out = model.apply(p, batch, opts, train=True, rngs={"dropout": rng})
        return loss, aux, g, out.pred_idx
    return jax.device_get(_jit(step)(params))


def _assert_grads(model, out, want, want32, skip=()):
    """Each trained leaf's grad by the median rule over its entries at
    k = 1/2 (measured up to 0.25). A Dense bias's grad is a bf16 number in
    the port, as flax's dtype makes it, while XLA's CPU compiler returns it
    unrounded (0.22705078, between two bf16 numbers, for the port's
    0.22753906), and it sums the chaotic bf16 cotangents of every row: the
    biases of units without a norm are held to 5e-2 of the leaf's largest
    magnitude (measured 2.1e-3); a bias before a norm feeds a mean that the
    norm subtracts, and its grad is what little of the sum does not cancel
    (0.13-0.2 of its scale apart, a few bf16 roundings of the terms): those
    are held to be finite (ROADMAP.md Queue 3). Blind biases (`skip`) are
    rounding noise in both packages and are left out."""
    normed = {f"{name}.dense.bias" for name, m in model.named_modules()
              if isinstance(m, ConvUnit) and (m.norm is not None or m.scale is not None)}
    for key, grad in out["grads"].items():
        if key in skip:
            continue
        g, w, w32 = grad.numpy(), T.leaf(want, key), T.leaf(want32, key)
        assert g.dtype == np.float32 and np.isfinite(g).all(), key
        if key in normed:
            continue
        if key.endswith("dense.bias"):
            P.assert_scaled(g, w, 5e-2, key)
        else:
            assert_discriminating(g, w, w32, 0.5, key)


def test_align_step_bf16_matches_jax():
    """One align step at 256 points with the inlier net, the trained part,
    in bf16 (its forward and backward), against JAX's: every iteration's
    matches equal (asserted), the loss terms by the rule at k = 1/4, the
    inlier grads leaf by leaf as `_assert_grads`; params and grads fp32.
    (With compute_dtype bf16 too, 1.4% of iteration-1 matches differ, and
    the loss terms with them; the staged checkpoint's step above holds that
    case.)"""
    options = dict(inlier_compute_dtype="bfloat16")
    jcfg, cfgs = T.configs(options, {})
    jcfg32, _ = T.configs({}, {})
    arrays = T.arrays_for(jcfg)
    state = init_params(cfgs.model, seed=3)
    model = Network(cfgs.model)
    model.load_state_dict(state)
    batch = device_batch(cfgs.model, arrays, device="cpu")
    pyr = [T.jax_pyramid(getattr(batch, f"pyramid_{s}")) for s in ("src", "ref")]
    jbatch = JaxPairBatch(jnp.asarray(arrays["points_src"]), jnp.asarray(arrays["points_ref"]),
                          *pyr, jnp.asarray(arrays["transform_gt"]))
    params = to_jax_params(state)
    loss, aux, grads, pred = _jax_grads(jcfg, params, jbatch, False)
    loss32, aux32, grads32, _ = _jax_grads(jcfg32, params, jbatch, False)
    out = train_step(model, make_optimizer(model), cfgs, arrays,
                     torch.Generator().manual_seed(0), 1)
    assert not out["skipped"]
    held = chip_smoke._held(out["pred_idx"].numpy(), np.asarray(pred))
    assert held == len(pred), held
    for key, value in out["losses"].items():
        w, w32 = float(aux["losses"][key]), float(aux32["losses"][key])
        assert abs(float(value) - w) <= QUARTER * abs(w - w32), (key, float(value), w, w32)
    _assert_grads(model, out, grads, grads32, skip=T.blind_biases(model))
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_label_step_bf16_matches_jax():
    """One label step at 256 points in bf16 against JAX's bf16 step: the
    loss by the rule at k = 1/4, the backbone's grads leaf by leaf as
    `_assert_grads`; params fp32 after the update."""
    jcfg, cfgs = P.configs("label", dict(compute_dtype="bfloat16"))
    jcfg32, _ = P.configs("label", {})
    arrays = P.synthetic_arrays(jcfg)
    state = init_params(cfgs.model, seed=3, pipeline="label")
    model = Network(cfgs.model, "label")
    model.load_state_dict(state)
    batch = device_batch(cfgs.model, arrays, device="cpu")
    jbatch = P.jax_batch(arrays, batch)
    params = to_jax_params(state)
    loss, _, grads, _ = _jax_grads(jcfg, params, jbatch, False, "label")
    loss32, _, grads32, _ = _jax_grads(jcfg32, params, jbatch, False, "label")
    opt = make_optimizer(model)
    out = train_step(model, opt, cfgs, arrays, torch.Generator().manual_seed(0), 1)
    assert not out["skipped"]
    assert abs(float(out["loss"]) - float(loss)) <= QUARTER * abs(float(loss) - float(loss32))
    _assert_grads(model, out, grads, grads32, skip=P.blind_biases(model))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
