"""Reading the JAX package's flax checkpoints (deepsir_tpu/utils/checkpoint.py:30-64).

A checkpoint file is flax msgpack (`flax.serialization.to_bytes`) holding
either a whole training state `{"state": {"params", "opt_state", "step"},
"step"}` or a bare params tree. It is decoded with the port's own msgpack
reader (utils/msgpack.py), so reading one needs neither flax nor msgpack.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Union

from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.network import Network
from deepsir_tpu_torch.utils.msgpack import unpackb
from deepsir_tpu_torch.utils.params import from_jax_params, load_network

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
                    device="cuda") -> Network:
    """Network(cfg) on `device` in eval mode with the checkpoint's weights;
    every stored leaf is used exactly once (`from_jax_params`)."""
    return load_network(cfg, from_jax_params(read_params(path), Network(cfg)), device)
