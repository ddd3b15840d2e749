"""Reading and writing the JAX package's flax checkpoints
(deepsir_tpu/utils/checkpoint.py).

A checkpoint file is flax msgpack (`flax.serialization.to_bytes`) holding
either a whole training state `{"state": {"params", "opt_state", "step"},
"step"}` or a bare params tree. It is decoded and encoded with the port's
own msgpack code (utils/msgpack.py), so neither needs flax nor msgpack. A
training state the port writes loads in the JAX package
(`partial_restore`, `CheckPointManager.load` into the TrainState of its
pipeline), and the port resumes one the JAX package wrote: params, Adam
moments and count. `partial_restore` starts a stage of the staged regimen
(label, then feat, then align) from the checkpoint of the stage before, as
the JAX package's train.py does.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Union

from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.network import Network
import numpy as np
import torch

from deepsir_tpu_torch.utils.msgpack import packb, unpackb
from deepsir_tpu_torch.utils.params import (_flatten, flax_path, from_jax_params,
                                            load_jax_opt_state, load_network,
                                            to_jax_opt_state, to_jax_params)

BEST = "model_best.msgpack"


def resolve(path: Union[str, os.PathLike]) -> Path:
    """A checkpoint file, or a directory's model_best.msgpack (as
    `partial_restore` resolves it)."""
    p = Path(path)
    return p / BEST if p.is_dir() else p


def read_params(path: Union[str, os.PathLike]) -> Dict:
    """The nested flax params tree (numpy leaves) stored at `path`."""
    raw = unpackb(resolve(path).read_bytes())
    stored = raw.get("state", raw)
    # a whole training state, or a bare params tree
    if "params" in stored and "opt_state" in stored:
        stored = stored["params"]
    return stored


def load_checkpoint(cfg: ModelConfig, path: Union[str, os.PathLike],
                    device="cuda", pipeline: str = "align") -> Network:
    """Network(cfg, pipeline) on `device` in eval mode with the checkpoint's
    weights; every stored leaf is used exactly once (`from_jax_params`)."""
    model = Network(cfg, pipeline)
    return load_network(cfg, from_jax_params(read_params(path), model), device, pipeline)


@torch.no_grad()
def partial_restore(path: Union[str, os.PathLike], model: Network) -> int:
    """Copy into `model` every stored parameter leaf whose flax path is a
    parameter of `model` and whose shape matches; every other parameter
    keeps its value (deepsir_tpu/utils/checkpoint.py:partial_restore, the
    start of a stage from the stage before). Returns the leaves loaded."""
    stored = _flatten(read_params(path))
    loaded = 0
    for key, param in model.state_dict().items():
        path_, transpose = flax_path(key)
        value = stored.get(("params",) + path_)
        if not isinstance(value, np.ndarray):
            continue
        value = value.T if transpose else value
        if tuple(value.shape) == tuple(param.shape):
            param.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            loaded += 1
    return loaded


def save_checkpoint(path: Union[str, os.PathLike], model: Network,
                    optimizer: torch.optim.Optimizer, step: int) -> Path:
    """Write `model`'s params and `optimizer`'s Adam state (made by
    training.make_optimizer) as the JAX package's CheckPointManager.save
    writes a TrainState: {"state": {"params": {"params": tree}, "opt_state":
    optax tree, "step": int32}, "step": step}. Returns the file's path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {"params": to_jax_params(model.state_dict()),
             "opt_state": to_jax_opt_state(model, optimizer),
             "step": np.asarray(step, np.int32)}
    path.write_bytes(packb({"state": state, "step": int(step)}))
    return path


def load_train_state(path: Union[str, os.PathLike], model: Network,
                     optimizer: torch.optim.Optimizer) -> int:
    """Resume from a whole training state (a file, or a directory's
    model_best.msgpack) written by the JAX package or `save_checkpoint`:
    load its params into `model` (every leaf once) and its Adam moments and
    count into `optimizer`. Returns the stored step."""
    raw = unpackb(resolve(path).read_bytes())
    state = raw["state"]
    sd = from_jax_params(state["params"], model)
    model.load_state_dict(sd, strict=True)
    load_jax_opt_state(state["opt_state"], model, optimizer)
    return int(raw["step"])
