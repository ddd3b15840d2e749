"""`config.from_run_config`: every tracked align run's config.json maps to a
port ModelConfig that `check_supported` admits, field for field as the JAX
package reads it; unknown keys, another pipeline and precision the port
does not compute raise."""
import dataclasses
import json
from pathlib import Path

import pytest

from deepsir_tpu.config import ModelConfig as JaxModelConfig
from deepsir_tpu_torch.config import IGNORED_KEYS, ModelConfig, from_run_config
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
    # every key is a field or an ignored key; and the JAX config has no
    # field the port neither reads nor ignores
    jax_fields = {f.name for f in dataclasses.fields(JaxModelConfig)}
    port_fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert set(run["model"]) <= port_fields | set(IGNORED_KEYS)
    assert jax_fields == port_fields | set(IGNORED_KEYS)


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
    assert set(IGNORED_KEYS) == {"num_sub", "dropout_rate", "knn_recall_target",
                                 "matcher_method", "num_train_reg_iter", "no_slack",
                                 "num_sk_iter"}
    for key, reason in IGNORED_KEYS.items():
        assert len(reason) > 20, key
    run = json.loads(STAGED.read_text())
    base = from_run_config(run)
    for key, value in (("num_sub", 128), ("dropout_rate", 0.1), ("knn_recall_target", 1.0),
                       ("matcher_method", "xla"), ("num_train_reg_iter", 3),
                       ("no_slack", True), ("num_sk_iter", 9)):
        changed = json.loads(json.dumps(run))
        changed["model"][key] = value
        assert from_run_config(changed) == base, key


@pytest.mark.parametrize("value", ["default", "high"])
def test_matmul_precision_other_than_highest_raises(value):
    run = json.loads(STAGED.read_text())
    run["model"]["matmul_precision"] = value
    with pytest.raises(NotImplementedError, match="matmul_precision"):
        from_run_config(run)


@pytest.mark.parametrize("value", ["default", "high", "highest"])
def test_scoped_precision_fields_are_kept(value):
    run = json.loads(STAGED.read_text())
    run["model"].update(inlier_matmul_precision=value, matcher_matmul_precision=value)
    cfg = from_run_config(run)
    assert cfg.inlier_matmul_precision == cfg.matcher_matmul_precision == value


@pytest.mark.parametrize("path", OTHER)
def test_label_and_feat_configs_raise(path):
    with pytest.raises(ValueError, match="pipeline"):
        from_run_config(ROOT / path)
