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
the JAX package's train.py does. `CheckPointManager` keeps a training run's
checkpoints as the JAX package's does (deepsir_tpu/utils/checkpoint.py), with
the same file names and manifest.
"""
from __future__ import annotations

import logging
import os
import shutil
import time
from pathlib import Path
from typing import Dict, Optional, Union

from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.network import Network
import numpy as np
import torch

from deepsir_tpu_torch.utils.msgpack import packb, unpackb
from deepsir_tpu_torch.utils.params import (_flatten, flax_path, from_jax_params,
                                            load_jax_opt_state, load_network,
                                            to_jax_opt_state, to_jax_params)

BEST = "model_best.msgpack"
_logger = logging.getLogger("CheckPointManager")


def resolve(path: Union[str, os.PathLike]) -> Path:
    """A checkpoint file, or a directory's model_best.msgpack (as
    `partial_restore` resolves it)."""
    p = Path(path)
    return p / BEST if p.is_dir() else p


def read_params(path: Union[str, os.PathLike]) -> Dict:
    """The nested flax params tree (numpy leaves) stored at `path`."""
    return _params_of(unpackb(resolve(path).read_bytes()))


def _params_of(raw: Dict) -> Dict:
    """The params tree of a decoded checkpoint."""
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


class CheckPointManager:
    """A run's checkpoints: `<prefix>_<step>.msgpack` training states (written
    by `save_checkpoint`), a ring of the last `max_to_keep`, of which one
    leaving the ring is kept for good when it was saved at least
    keep_checkpoint_every_n_hours after the last one kept, a copy of the
    best-scoring one as `<prefix>_best.msgpack`, and the `checkpoints.txt`
    manifest (the files kept, then "Best step: <step>")."""

    def __init__(self, save_dir: str, prefix: str = "model", max_to_keep: int = 5,
                 keep_checkpoint_every_n_hours: float = 10000.0):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep {max_to_keep} < 1")
        self.save_dir = save_dir
        self.prefix = prefix
        self.max_to_keep = max_to_keep
        self.keep_every_s = keep_checkpoint_every_n_hours * 3600.0
        self._buffer = []          # [(path, save time)]
        self._permanent = []
        self._next_keep_time = time.time()
        self.best_score = -float("inf")
        self.best_step: Optional[int] = None
        os.makedirs(save_dir, exist_ok=True)

    def _path(self, step) -> str:
        return os.path.join(self.save_dir, f"{self.prefix}_{step}.msgpack")

    def save(self, model: Network, optimizer: torch.optim.Optimizer, step: int,
             score: float = 0.0) -> str:
        """Write the training state of `step`; it becomes the best copy when
        `score` beats every score before."""
        path = self._path(step)
        save_checkpoint(path, model, optimizer, step)
        # a step saved again (the final save after a periodic one) keeps one
        # ring entry; a step already kept for good stays out of the ring
        if not any(p == path for (p, _) in self._permanent):
            self._buffer = [(p, t) for (p, t) in self._buffer if p != path]
            self._buffer.append((path, time.time()))
        _logger.info("Saved checkpoint: %s (score %.4g, best %.4g)", path, score,
                     self.best_score)
        if score > self.best_score:
            self.best_score = score
            self.best_step = step
            shutil.copyfile(path, self._path("best"))
            _logger.info("Checkpoint is current best")
        self._rotate()
        self._write_manifest()
        return path

    def load(self, path: str, model: Network,
             optimizer: Optional[torch.optim.Optimizer] = None) -> int:
        """Load a checkpoint file, or a directory's `<prefix>_best.msgpack`,
        into `model` (every leaf once) and, when given, its Adam state into
        `optimizer`. Returns the stored step."""
        if os.path.isdir(path):
            path = os.path.join(path, f"{self.prefix}_best.msgpack")
        if optimizer is not None:
            step = load_train_state(path, model, optimizer)
        else:
            raw = unpackb(Path(path).read_bytes())
            model.load_state_dict(from_jax_params(_params_of(raw), model), strict=True)
            step = int(raw.get("step", 0))
        _logger.info("Loaded checkpoint from %s (step %d)", path, step)
        return step

    def _rotate(self) -> None:
        while len(self._buffer) > self.max_to_keep:
            path, saved_at = self._buffer.pop(0)
            if saved_at > self._next_keep_time:
                self._permanent.append((path, saved_at))
                self._next_keep_time = saved_at + self.keep_every_s
            else:
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass

    def _write_manifest(self) -> None:
        names = [os.path.basename(p) for p, _ in self._permanent + self._buffer]
        with open(os.path.join(self.save_dir, "checkpoints.txt"), "w") as f:
            f.write("\n".join(names))
            f.write(f"\nBest step: {self.best_step}")
