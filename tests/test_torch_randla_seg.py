"""RandLA-Net's SemanticKITTI configuration through the port's label step,
against the plain reference `tests/plain_randla_net.py`, on the CPU at the
published widths (d_out 16/64/128/256, 16 neighbours, ratios 4/4/4/4, 19
classes, xyz input) and 2 pairs of 1024 points, on seeded weights from
`init_params`, under `randla_norm` x `label_head`.

Tolerances, each from what float32 rounding leaves (measured on this
comparison over the data seeds 0-7, and against the reference run in
float64, whose pyramid and dropout draws are the float32 ones):
- logits within 1e-5 of their largest magnitude: the two read 0.8-3.2e-6
  apart after ~20 units in float32;
- the loss within 1e-6 of its value (read: at most 1.2e-7);
- every trained leaf's gradient, under GroupNorm, within 1e-4 of the
  leaf's largest entry (read: at most 1.2e-5; each side's distance from
  float64 is of that size). Under batch norm the two sides take a branch
  differently here and there: a max-pool choice between two neighbours
  within ~1e-6 of each other, or a LeakyReLU input within rounding of 0,
  follows the last bits of the forward, and the batch norm's backward
  carries the changed row into every row of the batch. Each leaf is held
  to its own size: ||g_port - g|| within 1e-2 of ||g|| (read: 7.9e-4 at
  the seed used here, where the float32 reference is 7.8e-4 from float64
  and the port 1.2e-5; at most 6.1e-3 over the data seeds 0-7), and its
  direction within 1 - cos = 1e-4 of the reference's (read: 3.1e-7 here,
  at most 1.8e-5 over the seeds 0-7). Such a flip is rare and its size is
  not bounded by rounding: over the seeds 0-23 one (seed 10) reads 1.9e-2,
  with the float32 reference itself 1.9e-2 from float64 and the port
  1.1e-5;
- a bias that feeds a batch norm is blind (the norm subtracts its channel's
  mean): its gradient is rounding noise, held below 1e-6 of the network's
  largest gradient on both sides and left out of the update's comparison;
- one Adam update (lr 0.01): the port's step is Adam's first step of its
  own gradient, lr * g / (|g| + eps), within 5e-7 on every entry (read:
  1.2e-7, the parameters' float32 rounding). Where the reference's entry is
  settled, at least 100 x eps (1e-6) and within 1e-2 of the port's, that
  step moves by at most lr * 1e-2 * 1e-2 = 1e-6 between the two sides, and
  the parameters after the step agree within 2e-6 (read: at most 9.6e-7);
  at least 75% of the entries are settled (read: 82-99.8%). Elsewhere
  Adam's first step turns the gradients' rounding into steps of up to lr.

Also: `label_head="randla"` refused outside the label pipeline,
`randla_norm="batch"` refused under a data-parallel mesh, the head's
layout, the train command on the published options, and that the
reference, and its copy in the benchmark, import nothing of either package.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import ast
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import plain_randla_net as plain
from deepsir_tpu_torch import training
from deepsir_tpu_torch.config import (LossConfig, ModelConfig, RunConfig, TrainConfig,
                                      check_supported, from_run_config)
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.parallel.sharded import make_sharded_eval_step
from deepsir_tpu_torch.utils.params import init_params, trainable_parameters

ROOT = Path(__file__).resolve().parent.parent
REFERENCES = [ROOT / "tests" / "plain_randla_net.py",
              ROOT / "benchmark" / "reference" / "randla_net.py"]
PUBLISHED = dict(feat_len=3, num_points=1024, randla_skips="post", fc_norm="batch",
                 randla_norm="batch", label_head="randla")
TRAIN = TrainConfig(lr=0.01, lr_decay_epoch=1, lr_decay_ratio=0.95, lr_clip=0.0)
STEPS_PER_EPOCH = 500
ADAM_EPS = 1e-8


def label_arrays(b=2, n=1024, seed=0):
    """Pairs of clouds (normal x 10, each reference its source jittered and
    reshuffled) with labels 1..19 and 5% of the points 0 (ignored)."""
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(b, n, 3)) * 10).astype(np.float32)
    ref = (src + rng.normal(scale=0.02, size=src.shape)).astype(np.float32)
    labels = [np.where(rng.uniform(size=(b, n)) < 0.05, 0,
                       rng.integers(1, 20, size=(b, n))).astype(np.int32) for _ in range(2)]
    return {"points_src": src, "points_ref": ref[:, rng.permutation(n)],
            "transform_gt": np.broadcast_to(np.eye(3, 4, dtype=np.float32), (b, 3, 4)).copy(),
            "labels_src": labels[0], "labels_ref": labels[1]}


def _largest(x: torch.Tensor) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def _blind(name, grads):
    """A Dense bias feeding a batch norm (its unit holds a `scale`)."""
    return name.endswith("dense.bias") and name.replace("dense.bias", "scale") in grads


@pytest.mark.parametrize("label_head", ["randla", "deepsir"])
@pytest.mark.parametrize("randla_norm", ["batch", "group"])
def test_label_step_against_the_plain_reference(randla_norm, label_head):
    cfg = ModelConfig(**dict(PUBLISHED, randla_norm=randla_norm, label_head=label_head))
    weights = init_params(cfg, 0, "label")
    model = Network(cfg, "label")
    model.load_state_dict(weights)
    ref = plain.SegmentationNet(cfg)
    ref.load_state_dict(weights, strict=True)
    arrays = label_arrays()

    out = training.forward_step(model, cfg, arrays)
    with torch.no_grad():
        _, want_logits, _ = plain.forward_batch(ref, arrays)
    got = torch.cat([out.logits_src, out.logits_ref])
    assert float((got - want_logits).abs().max()) <= 1e-5 * float(want_logits.abs().max())

    before = {n: p.detach().clone() for n, p in trainable_parameters(model)}
    res = training.train_step(model, training.make_optimizer(model),
                              RunConfig(cfg, LossConfig(), TRAIN, "label"), arrays,
                              torch.Generator().manual_seed(5), STEPS_PER_EPOCH)
    want = plain.Trainer(ref, TRAIN, STEPS_PER_EPOCH).step(arrays,
                                                           torch.Generator().manual_seed(5))
    assert not res["skipped"] and want["applied"]
    assert abs(float(res["loss"]) - want["terms"]["total"]) <= 1e-6 * want["terms"]["total"]

    grads = want["grads"]
    assert set(res["grads"]) == set(grads)          # the whole feature extractor trains
    top = max(float(g.abs().max()) for g in grads.values())
    after = dict(ref.named_parameters())
    settled = entries = 0
    for name, p in trainable_parameters(model):
        g, g_port = grads[name], res["grads"][name]
        if _blind(name, grads):
            assert float(g.abs().max()) < 1e-6 * top and float(g_port.abs().max()) < 1e-6 * top
            continue
        if randla_norm == "group":
            assert float((g_port - g).abs().max()) <= 1e-4 * float(g.abs().max()), name
        else:
            gap = (g_port - g).double().norm() / g.double().norm()
            assert float(gap) <= 1e-2, name
            cos = torch.nn.functional.cosine_similarity(g_port.double().flatten(),
                                                         g.double().flatten(), dim=0)
            assert 1.0 - float(cos) <= 1e-4, name
        moved = p.detach()
        own = before[name] - TRAIN.lr * g_port / (g_port.abs() + ADAM_EPS)
        assert _largest(moved - own) <= 5e-7, name
        firm = (g.abs() >= 100 * ADAM_EPS) & ((g_port - g).abs() <= 1e-2 * g.abs())
        assert _largest((moved - after[name].detach())[firm]) <= 2e-6, name
        settled, entries = settled + int(firm.sum()), entries + g.numel()
    assert settled >= 0.75 * entries


def test_randla_head_layout():
    """RandLA-Net's head: fc1 and fc2 with their batch norms, fc with
    neither; `feat` is fc2's 32 channels; every encoder and decoder unit
    holds a batch norm's scale and no GroupNorm."""
    cfg = ModelConfig(**PUBLISHED)
    model = Network(cfg, "label")
    model.load_state_dict(init_params(cfg, 0, "label"))
    keys = list(model.state_dict())
    head = [k.split(".", 2)[2] for k in keys if k.split(".")[1] in ("fc1", "fc2", "fc")]
    assert head == ["scale", "bias", "dense.weight", "dense.bias"] * 2 + \
        ["dense.weight", "dense.bias"]
    assert not any(".norm." in k or "mlp_out" in k or "fc_label" in k for k in keys)
    assert sum(k.endswith(".scale") for k in keys) == 36
    out = training.forward_step(model, cfg, label_arrays(b=1, n=512))
    assert out.feat_src.shape == (1, 512, 32) and out.logits_src.shape == (1, 512, 19)


@pytest.mark.parametrize("pipeline", ["feat", "align"])
def test_randla_head_refused_outside_the_label_pipeline(pipeline):
    cfg = ModelConfig(**PUBLISHED)
    check_supported(cfg)
    check_supported(cfg, "label")
    with pytest.raises(NotImplementedError, match="label_head"):
        check_supported(cfg, pipeline)
    with pytest.raises(NotImplementedError, match="label_head"):
        Network(cfg, pipeline)


def test_batch_norm_refused_under_a_mesh():
    cfg = ModelConfig(**PUBLISHED)
    model = Network(cfg, "label")
    mesh = SimpleNamespace(data_group=None, group=None)
    with pytest.raises(NotImplementedError, match="randla_norm"):
        training.train_step(model, training.make_optimizer(model),
                            RunConfig(cfg, LossConfig(), TRAIN, "label"), label_arrays(),
                            torch.Generator().manual_seed(0), STEPS_PER_EPOCH, mesh=mesh)
    align = ModelConfig(randla_norm="batch")
    with pytest.raises(NotImplementedError, match="randla_norm"):
        make_sharded_eval_step(Network(align, "align"), align, mesh)


def test_train_command_runs_the_published_options(tmp_path):
    """The train command on the label pipeline with RandLA-Net's options
    (--dev: 1024 points), its config.json holding them and read back."""
    from deepsir_tpu_torch.cli import train as cli_train
    argv = ["--pipeline", "label", "--dataset_type", "Synthetic", "--feat_len", "3",
            "--randla_skips", "post", "--randla_norm", "batch", "--fc_norm", "batch",
            "--label_head", "randla", "-bs", "2", "--lr", "0.01", "--lr_decay_epoch", "1",
            "--lr_decay_ratio", "0.95", "--dev", "--max_epochs", "1",
            "--synthetic_train_size", "4", "-v", "0", "--logdir", str(tmp_path),
            "--device", "cpu"]
    run = Path(cli_train.main(argv))
    stored = json.loads((run / "config.json").read_text())
    assert (stored["model"]["randla_norm"], stored["model"]["label_head"]) == ("batch", "randla")
    assert from_run_config(run) == ModelConfig(**dict(PUBLISHED, num_points=1024))
    assert (run / "ckpt" / "checkpoints.txt").is_file()


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_either_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "typing", "numpy", "torch"}, tops


def test_the_benchmark_holds_a_copy_of_the_reference():
    assert REFERENCES[0].read_text() == REFERENCES[1].read_text()
