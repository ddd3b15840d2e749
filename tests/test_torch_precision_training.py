"""bf16 compute in the port against the JAX package, on the CPU, with
trained weights and in training: the staged align checkpoint at 1024 points
under B16, B16F and I16 (`chip_smoke.precision_parity` and
`precision_step_parity` against tests/data/torch_parity_precision.npz), and
one align and one label training step at 256 points against JAX's bf16
steps. The references and the gates are tests/test_torch_precision.py's
(its docstring gives them and their measured values); that file holds the
search hook, the layers, the backbone and the small align forwards.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_pipelines as P
import test_torch_train as T
from deepsir_tpu.models import ForwardOptions as JaxForwardOptions, Network as JaxNetwork
from deepsir_tpu.models.network import PairBatch as JaxPairBatch
from deepsir_tpu.training import compute_loss as jax_compute_loss
from deepsir_tpu_torch.models.layers import ConvUnit
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.training import device_batch, make_optimizer, train_step
from deepsir_tpu_torch.utils.params import init_params, to_jax_params
from test_torch_precision import F, QUARTER, _jit, assert_discriminating


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
