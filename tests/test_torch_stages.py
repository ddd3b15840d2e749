"""The staged regimen's checkpoints in the port: the label and feat
checkpoints of logs_r3/staged_po load, resume and write back; the chain
label -> feat -> align of `utils.checkpoint.partial_restore` equals the
JAX package's; and the trained weights reproduce JAX's eval forward and
resumed step stored in tests/data/torch_parity_stages.npz.

Tolerances (trained weights, 1024 points, the port's pyramids equal to the
float64 ones JAX ran over): label logits within 1e-4 of the largest
|logit|, at most 0.1% of argmax flips; feat scores and descriptors 1e-5 of
their scale; losses 1e-5 relative, accuracies equal; one resumed step of
each at dropout 0: loss 1e-5 relative, each trained leaf's grad 1e-4 and
its param after the step 1e-5 of the leaf's scale (chip_smoke.leaf_error).
The chain: leaf counts and every leaf equal.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from deepsir_tpu.models import Network as JaxNetwork
from deepsir_tpu.training import device_batch as jax_device_batch
from deepsir_tpu.utils import checkpoint as jax_checkpoint
from deepsir_tpu_torch.config import from_run_config, read_run_config
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.training import make_optimizer
from deepsir_tpu_torch.utils import checkpoint
from deepsir_tpu_torch.utils.msgpack import unpackb
from deepsir_tpu_torch.utils.params import (flax_path, init_params, to_jax_params,
                                            trainable_parameters)

ROOT = Path(__file__).resolve().parent.parent
RUNS = {k: ROOT / v.relative_to(chip_smoke.ROOT) for k, v in chip_smoke.STAGE_RUNS.items()}
# (leaves, params, stored step)
STORED = {"label": (155, 1_330_467, 960), "feat": (185, 1_416_771, 480),
          "align": (340, 2_746_668, 1760)}


def network(pipeline, num_points=None):
    cfg = from_run_config(RUNS[pipeline])
    if num_points:
        cfg = chip_smoke.stage_config(pipeline, num_points).model if pipeline != "align" else cfg
    return cfg, Network(cfg, pipeline)


@pytest.mark.parametrize("pipeline", ["label", "feat", "align"])
def test_each_stage_checkpoint_loads_every_leaf_once(pipeline):
    cfg, _ = network(pipeline)
    model = checkpoint.load_checkpoint(cfg, RUNS[pipeline] / "ckpt", device="cpu",
                                       pipeline=pipeline)
    leaves, params, _ = STORED[pipeline]
    assert len(model.state_dict()) == leaves
    assert sum(p.numel() for p in model.parameters()) == params
    # another pipeline's network cannot take the file whole
    other = {"label": "feat", "feat": "align", "align": "label"}[pipeline]
    with pytest.raises(ValueError, match="do not match"):
        checkpoint.load_checkpoint(cfg, RUNS[pipeline] / "ckpt", device="cpu", pipeline=other)


@pytest.mark.parametrize("pipeline", ["label", "feat"])
def test_load_train_state_resumes_the_adam_state(pipeline):
    cfg, model = network(pipeline)
    opt = make_optimizer(model)
    assert checkpoint.load_train_state(RUNS[pipeline] / "ckpt", model, opt) == STORED[pipeline][2]
    raw = unpackb((RUNS[pipeline] / "ckpt" / checkpoint.BEST).read_bytes())["state"]
    adam = raw["opt_state"]["inner_states"]["train"]["inner_state"]["0"]
    count = int(adam["count"])
    trained = trainable_parameters(model)
    assert {id(p) for _, p in trained} == {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in trained:
        path, transpose = flax_path(name)
        state = opt.state[p]
        assert int(state["step"]) == count
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            tree = adam[moment]["params"]
            for k in path:
                tree = tree[k]
            want = tree.T if transpose else tree
            assert torch.equal(state[key], torch.from_numpy(np.ascontiguousarray(want))), name
    # the frozen leaves hold no moments in the file
    frozen = [n for n, _ in model.named_parameters() if n not in dict(trained)]
    assert (pipeline == "label") == (not frozen)


@pytest.mark.parametrize("pipeline", ["label", "feat"])
def test_a_resumed_checkpoint_writes_back_the_same_bytes(pipeline, tmp_path):
    _, model = network(pipeline)
    opt = make_optimizer(model)
    step = checkpoint.load_train_state(RUNS[pipeline] / "ckpt", model, opt)
    path = checkpoint.save_checkpoint(tmp_path / "model_best.msgpack", model, opt, step)
    assert path.read_bytes() == (RUNS[pipeline] / "ckpt" / checkpoint.BEST).read_bytes()


def _jax_partial_restore(source, into, state):
    """JAX's partial_restore of `source`'s checkpoint into a params tree
    holding `state` (the port's seeded params)."""
    cfg, _ = network(into)
    fx = np.load(chip_smoke.STAGE_FIXTURE)
    arrays = {k: fx[k][:1] for k in ("points_src", "points_ref", "transform_gt")}
    jcfg = chip_smoke_jax_config(into)
    model = JaxNetwork(jcfg.model, pipeline=into)
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0),
                                                 jax_device_batch(jcfg, a)), arrays)
    target = to_jax_params(state)
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(target)
    return jax_checkpoint.partial_restore(str(RUNS[source] / "ckpt"), target)


def chip_smoke_jax_config(pipeline):
    from deepsir_tpu.config import Config, ModelConfig
    run = json.loads((RUNS[pipeline] / "config.json").read_text())
    model = {k: tuple(v) if isinstance(v, list) else v for k, v in run["model"].items()}
    return Config(pipeline=pipeline, model=ModelConfig(**model))


@pytest.mark.parametrize("source,into,loaded", [("label", "feat", 155), ("feat", "align", 185),
                                                ("label", "align", 155)])
def test_partial_restore_equals_jax_leaf_for_leaf(source, into, loaded):
    cfg, model = network(into)
    state = init_params(cfg, seed=1, pipeline=into)
    model.load_state_dict(state)
    assert checkpoint.partial_restore(RUNS[source] / "ckpt", model) == loaded
    want, want_loaded = _jax_partial_restore(source, into, state)
    assert want_loaded == loaded
    got = to_jax_params(model.state_dict())
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want) == STORED[into][0]
    changed = 0
    for path, value in flat_got:
        np.testing.assert_array_equal(value, np.asarray(flat_want[path]), err_msg=str(path))
    for key, value in model.state_dict().items():
        changed += not torch.equal(value, state[key])
    # the loaded leaves replaced the seeded ones; the rest kept their values
    assert changed == loaded


def test_partial_restore_skips_a_shape_mismatch():
    """A leaf whose shape differs stays as it was (JAX's rule): a feat
    network of another descriptor width takes only the backbone leaves of
    matching shape from the label checkpoint."""
    cfg, _ = network("feat")
    narrow = cfg.__class__(**{**cfg.__dict__, "out_feat_dim": 32})
    model = Network(narrow, "feat")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = checkpoint.partial_restore(RUNS["label"] / "ckpt", model)
    stored = checkpoint.read_params(RUNS["label"] / "ckpt")["params"]["feat_extractor"]
    assert 0 < loaded < 155
    assert torch.equal(model.feat_extractor.mlp_out.weight, state["feat_extractor.mlp_out.weight"])
    np.testing.assert_array_equal(model.feat_extractor.mlp_pre.dense.weight.detach().numpy(),
                                  stored["mlp_pre"]["Dense_0"]["kernel"].T)


def test_every_tracked_run_config_reads():
    runs = sorted(p for p in ROOT.glob("logs_r*/**/config.json")
                  if "code" not in p.relative_to(ROOT).parts)
    pipelines = [read_run_config(p).pipeline for p in runs]
    assert {p: pipelines.count(p) for p in set(pipelines)} == {"align": 120, "label": 8,
                                                                "feat": 4}
    batch = [p for p in runs if read_run_config(p).model.fc_norm == "batch"]
    assert [p.relative_to(ROOT).parts[1] for p in batch] == ["label_batch30_eval",
                                                             "label_batch60_eval"]


@pytest.mark.parametrize("pipeline", ["label", "feat"])
def test_the_stages_fixture_reproduces_on_the_cpu(pipeline):
    launches, rec = chip_smoke.stage_parity(torch, "cpu", pipeline)
    assert not any(launches.values())          # the CPU runs the plain versions
    assert rec["step"]["count"] == STORED[pipeline][2] and not rec["step"]["skipped"]
    if pipeline == "label":
        assert rec["logits"] <= 1e-4 and rec["argmax_flip_share"] <= 1e-3


def test_the_stages_chain_matches_the_fixture():
    fx = np.load(chip_smoke.STAGE_FIXTURE)
    for source, into in (("label", "feat"), ("feat", "align")):
        cfg, model = network(into)
        assert [checkpoint.partial_restore(RUNS[source] / "ckpt", model),
                len(model.state_dict())] == fx[f"chain/{source}->{into}"].tolist()
    for stage in ("label", "feat", "align"):
        assert fx[f"chain/{stage}->{stage}"].tolist() == [STORED[stage][0]] * 2
