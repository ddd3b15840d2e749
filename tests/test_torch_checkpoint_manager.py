"""`utils.checkpoint.CheckPointManager` against the JAX package's: the same
save sequence (steps, scores, a fake clock that crosses the keep-every
interval) leaves the same files and the same checkpoints.txt in both; a
directory resolves to model_best.msgpack; JAX's CheckPointManager.load
reads the port's best checkpoint into its TrainState bit for bit, and the
port's load reads JAX's (params, Adam moments, count, step) bit for bit."""
import os
import time

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

from deepsir_tpu.config import Config, ModelConfig as JaxModelConfig
from deepsir_tpu.training import create_train_state
from deepsir_tpu.utils.checkpoint import CheckPointManager as JaxManager
from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.training import adam_count, make_optimizer
from deepsir_tpu_torch.utils.checkpoint import CheckPointManager, read_params
from deepsir_tpu_torch.utils.params import init_params, to_jax_opt_state, to_jax_params

MODEL = dict(feat_len=3, num_points=256, num_knn=8, sub_sampling_ratio=(4, 4), d_out=(8, 16),
             out_feat_dim=16, num_classes=5, num_reg_iter=2)
# (step, score, seconds on the clock): the ring of 2 evicts steps 10, 20, 30,
# 40; of those, 10 and 40 were saved past the keep-every hour and stay
SAVES = [(10, 0.1, 1.0), (20, 0.5, 1200.0), (30, 0.3, 2400.0), (40, 0.7, 3700.0),
         (50, 0.2, 4000.0), (60, 0.9, 5000.0), (70, 0.6, 6000.0), (70, -np.inf, 6001.0)]


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _port_model():
    cfg = ModelConfig(**MODEL)
    model = Network(cfg)
    model.load_state_dict(init_params(cfg, seed=0))
    return model, make_optimizer(model)


def _run(manager_cls, directory, saver, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "time", clock)
    manager = manager_cls(str(directory), max_to_keep=2, keep_checkpoint_every_n_hours=1.0)
    for step, score, now in SAVES:
        clock.now = now
        saver(manager, step, score)
    return manager


def test_ring_promotion_best_and_manifest_match_jax(tmp_path, monkeypatch):
    model, opt = _port_model()
    jax_mgr = _run(JaxManager, tmp_path / "jax",
                   lambda m, step, score: m.save({"w": np.arange(3.0)}, step, score=score),
                   monkeypatch)
    port_mgr = _run(CheckPointManager, tmp_path / "port",
                    lambda m, step, score: m.save(model, opt, step, score=score), monkeypatch)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert files == ["checkpoints.txt", "model_10.msgpack", "model_40.msgpack",
                     "model_60.msgpack", "model_70.msgpack", "model_best.msgpack"]
    manifest = (tmp_path / "port" / "checkpoints.txt").read_text()
    assert manifest == (tmp_path / "jax" / "checkpoints.txt").read_text()
    assert manifest.splitlines()[-1] == "Best step: 60"
    assert (port_mgr.best_step, port_mgr.best_score) == (jax_mgr.best_step, jax_mgr.best_score)
    assert (tmp_path / "port" / "model_best.msgpack").read_bytes() == \
        (tmp_path / "port" / "model_60.msgpack").read_bytes()


def test_max_to_keep_must_be_positive(tmp_path):
    with pytest.raises(ValueError):
        CheckPointManager(str(tmp_path), max_to_keep=0)


@pytest.fixture(scope="module")
def jax_state():
    cfg = Config(pipeline="align", model=JaxModelConfig(**MODEL))
    rng = np.random.default_rng(0)
    arrays = {"points_src": rng.normal(size=(1, 256, 3)).astype(np.float32),
              "points_ref": rng.normal(size=(1, 256, 3)).astype(np.float32),
              "transform_gt": np.eye(3, 4, dtype=np.float32)[None]}
    _, state = create_train_state(cfg, arrays, 4, seed=1)
    return state


def _flat(tree):
    """The leaves of a params or optax state tree by path."""
    tree = serialization.to_state_dict(jax.device_get(tree))
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def test_jax_loads_the_port_best_bit_equal(tmp_path, jax_state):
    model, opt = _port_model()
    # one Adam update, so that the moments and the count are not zeros
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        p.grad = torch.full_like(p, 0.25)
    opt.param_groups[0]["lr"] = 1e-3
    opt.step()
    manager = CheckPointManager(str(tmp_path / "ckpt"))
    manager.save(model, opt, 7, score=1.0)
    state, step = JaxManager(str(tmp_path / "ckpt")).load(str(tmp_path / "ckpt"), jax_state)
    assert step == 7 and int(state.step) == 7
    want = _flat(to_jax_params(model.state_dict()))
    got = _flat(state.params)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
    opt_want, opt_got = _flat(to_jax_opt_state(model, opt)), _flat(state.opt_state)
    assert opt_got.keys() == opt_want.keys()
    for key, value in opt_want.items():
        assert np.array_equal(opt_got[key], value), key
    assert any(v.ndim == 0 and v == 1 for v in opt_got.values())     # the Adam count


def test_the_port_loads_jax_best_bit_equal(tmp_path, jax_state):
    jax_mgr = JaxManager(str(tmp_path / "ckpt"))
    jax_mgr.save(jax_state, 3, score=0.5)
    model, opt = _port_model()
    step = CheckPointManager(str(tmp_path / "other")).load(str(tmp_path / "ckpt"), model, opt)
    assert step == 3 and adam_count(opt) == 0
    opt_got, opt_want = _flat(to_jax_opt_state(model, opt)), _flat(jax_state.opt_state)
    assert opt_got.keys() == opt_want.keys()
    for key, value in opt_want.items():
        assert np.array_equal(opt_got[key], value), key
    got = _flat(to_jax_params(model.state_dict()))
    want = _flat(jax_state.params)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert np.array_equal(got[key], value), key
    # params only, as the test command resumes: the same weights
    model2, _ = _port_model()
    assert CheckPointManager(str(tmp_path / "ckpt")).load(
        str(tmp_path / "ckpt" / "model_best.msgpack"), model2) == 3
    for (k, a), (_, b) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert torch.equal(a, b), k
    assert read_params(tmp_path / "ckpt").keys() == {"params"}
