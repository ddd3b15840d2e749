"""Checkpoints the port writes (deepsir_tpu_torch/utils/checkpoint.py
`save_checkpoint`, utils/msgpack.py `packb`) against the JAX package's
readers, and the port resuming a training state the JAX package wrote.

- `packb` writes what flax's `msgpack_serialize` writes, byte for byte, for
  trees of dicts and numpy arrays (0-d, empty, bool, int8 to float64);
  flax's `msgpack_restore` reads it back to the same tree, and so does the
  port's `unpackb`; every msgpack type round-trips as `msgpack.packb` packs it.
- The staged align checkpoint, resumed by `load_train_state` (count 1760,
  the stored moments bit for bit), written again by `save_checkpoint`:
  `partial_restore` loads 340 of 340 leaves, bit-equal to the port's params;
  `CheckPointManager.load` into the TrainState template of
  `create_train_state` gives bit-equal params, mu, nu, both Adam counts and
  the step. The file equals the JAX checkpoint it was resumed from, byte
  for byte: nothing was lost or reordered.
"""
import torch_workers  # noqa: F401  (torch's threads under xdist)
import dataclasses
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import empty_node, flatten_dict, unflatten_dict

from deepsir_tpu.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig
from deepsir_tpu.training import create_train_state
from deepsir_tpu.utils.checkpoint import CheckPointManager, partial_restore
from deepsir_tpu_torch.config import read_run_config
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.training import adam_count, make_optimizer
from deepsir_tpu_torch.utils.checkpoint import load_train_state, resolve, save_checkpoint
from deepsir_tpu_torch.utils.msgpack import packb, unpackb
from deepsir_tpu_torch.utils.params import flax_path, to_jax_params

ROOT = Path(__file__).resolve().parent.parent
STAGED = ROOT / "logs_r3" / "staged_po" / "260817_191109_align"


def _tree(rng):
    return {"a": {"e": np.zeros((0, 3), np.float32), "k": rng.normal(size=(3, 5)).astype(np.float32),
                  "s": np.asarray(3, np.int32)},
            "b": {}, "c": np.arange(70000, dtype=np.int8),
            "d": {"flag": np.asarray([True, False]), "w": rng.normal(size=(2, 2))}}


def test_packb_writes_what_flax_writes_and_reads_back():
    tree = _tree(np.random.default_rng(0))
    data = packb(tree)
    assert data == serialization.msgpack_serialize(tree)
    for restored in (serialization.msgpack_restore(data), unpackb(data)):
        flat, want = flatten_dict(restored, keep_empty_nodes=True), \
            flatten_dict(tree, keep_empty_nodes=True)
        assert list(flat) == list(want)
        for path, w in want.items():
            g = flat[path]
            if isinstance(w, np.ndarray):
                assert (g.dtype, g.shape, g.tobytes()) == (w.dtype, w.shape, w.tobytes()), path
            else:
                assert g == w, path


@pytest.mark.parametrize("value", [None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
                                   2**32, 2**64 - 1, -1, -32, -33, -129, -2**15 - 1, -2**63,
                                   0.5, -1e300, "", "a" * 31, "b" * 32, "c" * 300, "d" * 70000,
                                   b"\x00\x01", [1] * 16, list(range(70000)),
                                   {str(i): i for i in range(16)}])
def test_every_msgpack_type_packs_as_msgpack_does(value):
    data = packb(value)
    assert data == msgpack.packb(value, use_bin_type=True)
    assert unpackb(data) == value


@pytest.fixture(scope="module")
def resumed():
    """The staged checkpoint resumed into the port and written again."""
    cfgs = read_run_config(STAGED)
    model = Network(cfgs.model)
    opt = make_optimizer(model)
    step = load_train_state(STAGED / "ckpt", model, opt)
    return cfgs, model, opt, step


def test_load_train_state_resumes_the_jax_adam_state(resumed):
    _, model, opt, step = resumed
    assert step == 1760 and adam_count(opt) == 1760
    raw = unpackb(resolve(STAGED / "ckpt").read_bytes())
    adam = raw["state"]["opt_state"]["inner_states"]["train"]["inner_state"]["0"]
    n_moments = 0
    for name, p in model.inlier_model.named_parameters():
        path, transpose = flax_path("inlier_model." + name)
        state = opt.state[p]
        for key, tree in (("exp_avg", adam["mu"]["params"]), ("exp_avg_sq", adam["nu"]["params"])):
            for k in path:
                tree = tree[k]
            want = tree.T if transpose else tree
            assert torch.equal(state[key], torch.from_numpy(np.ascontiguousarray(want))), name
            n_moments += 1
        assert state["step"].dtype == torch.float32 and float(state["step"]) == 1760.0
    assert n_moments == 2 * 155


def test_a_written_checkpoint_loads_in_jax(resumed, tmp_path):
    cfgs, model, opt, step = resumed
    path = save_checkpoint(tmp_path / "ckpt" / "model_1760.msgpack", model, opt, step)
    # nothing lost, nothing reordered: the JAX checkpoint, byte for byte
    assert path.read_bytes() == resolve(STAGED / "ckpt").read_bytes()

    port = flatten_dict(to_jax_params(model.state_dict()))
    target = jax.tree_util.tree_map(np.zeros_like, unflatten_dict(port))
    merged, loaded = partial_restore(str(path), target)
    assert loaded == len(port) == 340
    for key, value in flatten_dict(jax.device_get(merged)).items():
        assert np.asarray(value).tobytes() == port[key].tobytes(), key

    example = {"points_src": np.random.default_rng(0).normal(size=(1, 256, 3)).astype(np.float32)}
    example["points_ref"] = example["points_src"]
    example["transform_gt"] = np.eye(3, 4, dtype=np.float32)[None]
    jcfg = _jax_config(cfgs)
    _, template = create_train_state(jcfg, example, steps_per_epoch=32)
    state, loaded_step = CheckPointManager(str(tmp_path / "ckpt")).load(str(path), template)
    assert loaded_step == step and int(state.step) == step
    for key, value in flatten_dict(jax.device_get(state.params)).items():
        assert np.asarray(value).tobytes() == port[key].tobytes(), key
    adam, sched = state.opt_state.inner_states["train"].inner_state
    assert int(adam.count) == int(sched.count) == 1760
    for name, p in model.inlier_model.named_parameters():
        path_, transpose = flax_path("inlier_model." + name)
        for moments, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            tree = moments["params"]
            for k in path_:
                tree = tree[k]
            got = np.asarray(tree)
            want = opt.state[p][key].numpy()
            assert (got.T if transpose else got).tobytes() == \
                np.ascontiguousarray(want).tobytes(), name


def test_a_fresh_optimizer_writes_zero_moments_and_count(tmp_path):
    cfgs = read_run_config(STAGED)
    model = Network(cfgs.model)
    path = save_checkpoint(tmp_path / "m.msgpack", model, make_optimizer(model), 0)
    raw = serialization.msgpack_restore(path.read_bytes())
    adam = raw["state"]["opt_state"]["inner_states"]["train"]["inner_state"]
    assert int(adam["0"]["count"]) == int(adam["1"]["count"]) == 0
    mu = flatten_dict(adam["0"]["mu"], keep_empty_nodes=True)
    inlier = [v for k, v in mu.items() if "inlier_model" in k]
    assert len(mu) == 340 and len(inlier) == 155
    assert all(not np.any(v) for v in inlier)
    assert all(v is empty_node for k, v in mu.items() if "inlier_model" not in k)
    # and it resumes into a fresh model and optimizer
    model2 = Network(cfgs.model)
    opt2 = make_optimizer(model2)
    assert load_train_state(path, model2, opt2) == 0 and adam_count(opt2) == 0
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), k


def _jax_config(cfgs):
    return Config(pipeline="align", model=ModelConfig(**dataclasses.asdict(cfgs.model)),
                  data=DataConfig(dataset_type="Synthetic"),
                  loss=LossConfig(**dataclasses.asdict(cfgs.loss)),
                  train=TrainConfig(**dataclasses.asdict(cfgs.train))).resolved()
