"""Parameters for the port: conversion from the JAX package's flax tree, and
a seeded initialisation.

Module names mirror the flax tree: flax's automatic names map to the port's
as `Dense_0` <-> `dense`, `GroupNorm_0` <-> `norm`, `ConvUnit_<i>` <->
`units.<i>` (an MLP's stack), `ConvUnit_0` <-> `unit` (inside AttPooling),
`enc_<i>` / `dec_<i>` <-> `enc.<i>` / `dec.<i>`. A flax Dense `kernel` (in, out)
becomes a torch `weight` (out, in); a GroupNorm `scale` becomes `weight`.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.layers import GroupNorm
from deepsir_tpu_torch.models.network import Network

_RENAME = {"dense": "Dense_0", "norm": "GroupNorm_0", "unit": "ConvUnit_0"}
_INDEXED = {"enc": "enc_{}", "dec": "dec_{}", "units": "ConvUnit_{}"}


def flax_path(torch_key: str) -> Tuple[Tuple[str, ...], bool]:
    """Torch state_dict key -> (flax param path, whether to transpose)."""
    parts = torch_key.split(".")
    leaf = parts.pop()
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in _INDEXED:
            out.append(_INDEXED[p].format(parts[i + 1]))
            i += 2
            continue
        out.append(_RENAME.get(p, p))
        i += 1
    if leaf == "weight" and parts and parts[-1] == "norm":
        return tuple(out) + ("scale",), False
    if leaf == "weight":
        return tuple(out) + ("kernel",), True
    return tuple(out) + (leaf,), False


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray], prefix: str = "param/") -> Dict:
    """{"<prefix>a/b/kernel": array} -> the nested tree {"a": {"b": {"kernel": array}}}."""
    tree: Dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, leaf = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return tree


def from_jax_params(params_np: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The flax `params` tree (numpy leaves) -> a state_dict for `model` (the
    align `Network` or any of its submodules).

    Every flax leaf is used exactly once: a torch parameter without a flax
    leaf, a leaf left over, or a shape mismatch raises ValueError.
    """
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    flat = _flatten(params_np)
    out, missing = {}, []
    for key, ref in model.state_dict().items():
        path, transpose = flax_path(key)
        if path not in flat:
            missing.append("/".join(path))
            continue
        arr = flat.pop(path)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} for {key} "
                             f"{tuple(ref.shape)}")
        out[key] = torch.tensor(arr, dtype=torch.float32)
    if missing or flat:
        raise ValueError(f"flax params do not match the network: missing "
                         f"{missing}, left over {['/'.join(p) for p in flat]}")
    return out


def _he_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax `he_normal` (truncated normal at +-2 sd, variance 2 / fan_in) for a
    torch (out, in) weight."""
    std = math.sqrt(2.0 / weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_params(cfg: ModelConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random parameters for Network(cfg), as flax initialises them:
    he-normal Linear weights, zero biases, unit GroupNorm scales."""
    gen = torch.Generator().manual_seed(seed)
    model = Network(cfg)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            _he_normal_(module.weight, gen)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, GroupNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
    return model.state_dict()


def load_network(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor],
                 device="cuda") -> Network:
    """Network(cfg) on `device` in eval mode with `state_dict` loaded strictly."""
    model = Network(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()
