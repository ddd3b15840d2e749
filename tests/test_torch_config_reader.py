"""`config.from_run_config` and `config.read_run_config`: every tracked
run's config.json (120 align, 8 label, 4 feat) maps to a port ModelConfig
that `check_supported` admits, and to its pipeline and its loss, train,
eval and data blocks, field for field as the JAX package reads them;
unknown keys, a pipeline outside the three and precision the port does not
compute raise."""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import dataclasses
import json
from pathlib import Path

import pytest

from deepsir_tpu.config import (Config, DataConfig, EvalConfig as JaxEvalConfig,
                                LossConfig as JaxLossConfig, ModelConfig as JaxModelConfig,
                                TrainConfig as JaxTrainConfig)
from deepsir_tpu_torch.config import (DataConfig as PortDataConfig, EvalConfig, LossConfig,
                                      ModelConfig, TrainConfig, from_run_config,
                                      read_run_config)
from deepsir_tpu_torch.models.network import Network

ROOT = Path(__file__).resolve().parent.parent
RUNS = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("logs_r*/**/config.json")
              if "code" not in p.relative_to(ROOT).parts)
ALIGN = [p for p in RUNS if json.loads((ROOT / p).read_text()).get("pipeline") == "align"]
OTHER = [p for p in RUNS if p not in ALIGN]
STAGED = ROOT / "logs_r3/staged_po/260817_191109_align/config.json"


def test_the_tracked_runs_are_found():
    assert len(ALIGN) == 120 and len(OTHER) == 12


@pytest.mark.parametrize("path", ALIGN)
def test_every_tracked_align_config_maps(path):
    run = json.loads((ROOT / path).read_text())
    cfg = from_run_config(ROOT / path)
    assert from_run_config(run) == cfg == from_run_config((ROOT / path).parent)
    # every field as the JAX package's config reads it (defaults included)
    jax_cfg = JaxModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in run["model"].items()})
    for field in dataclasses.fields(ModelConfig):
        assert getattr(cfg, field.name) == getattr(jax_cfg, field.name), field.name
    # every key is a field, and the two configs have the same fields
    jax_fields = {f.name for f in dataclasses.fields(JaxModelConfig)}
    port_fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert set(run["model"]) <= port_fields
    assert jax_fields == port_fields


def test_the_deploy_and_flagship_configs_build_a_network():
    flag = from_run_config(ROOT / "logs_r4/260819_171529_align_flag")
    assert (flag.inlier_num_layers, flag.inlier_num_knn, flag.inlier_extra_feats) == \
        (2, 8, "dist,recip")
    net = Network(flag)
    assert len(net.inlier_model.enc) == 2 and len(net.feat_extractor.enc) == 4


def test_an_unknown_key_raises_naming_it():
    run = json.loads(STAGED.read_text())
    run["model"]["use_flash"] = True
    with pytest.raises(ValueError, match="use_flash"):
        from_run_config(run)


def test_each_ignored_key_is_named_with_its_reason():
    """The four model keys that no forward reads (the JAX package's TPU
    implementation switches and sinkhorn options) are fields, read as
    stored, so that a run's config maps one for one; the keys the training
    step reads are fields too."""
    run = json.loads(STAGED.read_text())
    for key, value in (("knn_recall_target", 1.0), ("matcher_method", "xla"),
                       ("no_slack", True), ("num_sk_iter", 9),
                       ("dropout_rate", 0.1), ("num_train_reg_iter", 3), ("num_sub", 128)):
        changed = json.loads(json.dumps(run))
        changed["model"][key] = value
        assert getattr(from_run_config(changed), key) == value, key


@pytest.mark.parametrize("value", ["default", "high"])
def test_matmul_precision_other_than_highest_raises(value):
    """The JAX flag's three names are read (each at fp32 grade); a name
    outside them raises, naming the field."""
    run = json.loads(STAGED.read_text())
    run["model"]["matmul_precision"] = value
    assert from_run_config(run).matmul_precision == value
    run["model"]["matmul_precision"] = value + "est-ever"
    with pytest.raises(NotImplementedError, match="matmul_precision"):
        from_run_config(run)


@pytest.mark.parametrize("value", ["default", "high", "highest"])
def test_scoped_precision_fields_are_kept(value):
    run = json.loads(STAGED.read_text())
    run["model"].update(inlier_matmul_precision=value, matcher_matmul_precision=value)
    cfg = from_run_config(run)
    assert cfg.inlier_matmul_precision == cfg.matcher_matmul_precision == value


@pytest.mark.parametrize("path", OTHER)
def test_label_and_feat_configs_read_as_jax(path):
    """The label and feat configs read, with their pipeline, field for field
    as the JAX package reads them, and build their pipeline's network."""
    run = json.loads((ROOT / path).read_text())
    cfgs = read_run_config(ROOT / path)
    assert cfgs.pipeline == run["pipeline"] in ("label", "feat")
    assert cfgs.model == from_run_config(run)
    jax_cfg = _jax_config(run)
    for block, cls in (("model", ModelConfig), ("loss", LossConfig), ("train", TrainConfig)):
        for field in dataclasses.fields(cls):
            assert getattr(getattr(cfgs, block), field.name) == \
                getattr(getattr(jax_cfg, block), field.name), (block, field.name)
    Network(cfgs.model, cfgs.pipeline)


@pytest.mark.parametrize("path", OTHER)
def test_label_and_feat_configs_raise(path):
    """The label and feat configs' blocks under a pipeline outside the three
    raise."""
    run = json.loads((ROOT / path).read_text())
    run["pipeline"] = "segment"
    with pytest.raises(ValueError, match="pipeline"):
        from_run_config(run)
    with pytest.raises(ValueError, match="pipeline"):
        read_run_config(run)


def _jax_config(run):
    return Config(pipeline=run["pipeline"],
                  model=JaxModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                          for k, v in run["model"].items()}),
                  data=DataConfig(**run["data"]), loss=JaxLossConfig(**run["loss"]),
                  train=JaxTrainConfig(**run["train"]),
                  eval=JaxEvalConfig(**run.get("eval", {}))).resolved()


@pytest.mark.parametrize("path", ALIGN)
def test_loss_and_train_blocks_read_as_jax_reads_them(path):
    run = json.loads((ROOT / path).read_text())
    cfgs = read_run_config(ROOT / path)
    assert cfgs.model == from_run_config(run)
    jax_cfg = _jax_config(run)
    for field in dataclasses.fields(LossConfig):
        assert getattr(cfgs.loss, field.name) == getattr(jax_cfg.loss, field.name), field.name
    for field in dataclasses.fields(TrainConfig):
        assert getattr(cfgs.train, field.name) == getattr(jax_cfg.train, field.name), field.name
    # every JAX field is read or named with its reason
    jax_loss = {f.name for f in dataclasses.fields(JaxLossConfig)}
    assert jax_loss == {f.name for f in dataclasses.fields(LossConfig)}
    jax_train = {f.name for f in dataclasses.fields(JaxTrainConfig)}
    assert jax_train == {f.name for f in dataclasses.fields(TrainConfig)}
    assert dataclasses.asdict(cfgs.data) == dataclasses.asdict(jax_cfg.data)
    assert dataclasses.astuple(PortDataConfig()) == dataclasses.astuple(DataConfig())


def test_thres_radius_is_filled_from_the_data_block():
    run = json.loads(STAGED.read_text())
    run["loss"]["thres_radius"] = -1.0
    run["data"].update(voxel_size=0.05, positive_pair_radius_multiplier=4.0)
    cfgs = read_run_config(run)
    assert cfgs.loss.thres_radius == _jax_config(run).loss.thres_radius == 0.05 * 4.0
    run["loss"]["thres_radius"] = 0.7
    assert read_run_config(run).loss.thres_radius == 0.7


@pytest.mark.parametrize("block", ["loss", "train", "data"])
def test_an_unknown_loss_train_or_data_key_raises_naming_it(block):
    run = json.loads(STAGED.read_text())
    run[block]["use_magic"] = 1
    with pytest.raises(ValueError, match="use_magic"):
        read_run_config(run)


@pytest.mark.parametrize("path", RUNS)
def test_eval_block_reads_as_jax_reads_it(path):
    """Every tracked config's "eval" block maps onto EvalConfig field for
    field as the JAX package's resolved config reads it (the stored configs
    are resolved already), and its voxel size is the data block's."""
    run = json.loads((ROOT / path).read_text())
    cfgs = read_run_config(ROOT / path)
    jax_cfg = _jax_config(run)
    assert {f.name for f in dataclasses.fields(EvalConfig)} == \
        {f.name for f in dataclasses.fields(JaxEvalConfig)}
    for field in dataclasses.fields(EvalConfig):
        assert getattr(cfgs.eval, field.name) == getattr(jax_cfg.eval, field.name), field.name
    assert cfgs.voxel_size == jax_cfg.data.voxel_size


def test_eval_blocks_switch_the_refiners():
    evals = [read_run_config(ROOT / p).eval for p in RUNS]
    assert len(evals) == 132
    assert sum(e.use_finetune for e in evals) == 14
    assert sum(e.use_icp for e in evals) == 9
    assert sum(e.use_ransac for e in evals) == 8
    assert sum(e.pose_average_last > 1 for e in evals) == 2
    assert sum(e.transfer_dtype == "float16" for e in evals) == 1


def test_an_unknown_eval_key_raises_naming_it():
    run = json.loads(STAGED.read_text())
    run["eval"]["use_magic"] = 1
    with pytest.raises(ValueError, match="use_magic"):
        read_run_config(run)
    del run["eval"]
    assert read_run_config(run).eval == EvalConfig()
