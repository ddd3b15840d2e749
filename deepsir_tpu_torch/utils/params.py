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
from deepsir_tpu_torch.models.layers import ConvUnit, GroupNorm
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


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    """{path: leaf} of a nested tree; an empty map is a leaf (optax's masked
    node), any other leaf becomes a numpy array."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping) and v:
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v if isinstance(v, Mapping) else np.asarray(v)
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
    """The flax `params` tree (numpy leaves) -> a state_dict for `model` (a
    `Network` of any pipeline, or any of its submodules).

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


def init_params(cfg: ModelConfig, seed: int = 0,
                pipeline: str = "align") -> Dict[str, torch.Tensor]:
    """Seeded random parameters for Network(cfg, pipeline), as flax
    initialises them: he-normal Linear weights, zero biases, unit norm
    scales."""
    gen = torch.Generator().manual_seed(seed)
    model = Network(cfg, pipeline)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            _he_normal_(module.weight, gen)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, GroupNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, ConvUnit) and module.scale is not None:
            nn.init.ones_(module.scale)
            nn.init.zeros_(module.bias)
    return model.state_dict()


def load_network(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor],
                 device="cuda", pipeline: str = "align") -> Network:
    """Network(cfg, pipeline) on `device` in eval mode with `state_dict`
    loaded strictly."""
    model = Network(cfg, pipeline)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def _sorted_tree(tree: Mapping) -> Dict:
    """A nested dict with its keys sorted at every level, as JAX orders a
    params tree."""
    return {k: _sorted_tree(v) if isinstance(v, Mapping) else v
            for k, v in sorted(tree.items())}


def _to_flax_leaf(key: str, value: torch.Tensor) -> Tuple[Tuple[str, ...], np.ndarray]:
    path, transpose = flax_path(key)
    arr = value.detach().cpu().numpy()
    return path, np.ascontiguousarray(arr.T if transpose else arr)


def _nest(flat: Mapping[Tuple[str, ...], object]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if path[-1] in node:
            raise ValueError(f"two leaves at {'/'.join(path)}")
        node[path[-1]] = leaf
    return _sorted_tree(tree)


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """A state_dict of a `Network` -> the flax variables
    {"params": tree} with numpy leaves: the inverse of `from_jax_params`,
    every entry used once, Linear weights transposed back to kernels."""
    return {"params": _nest(dict(_to_flax_leaf(k, v) for k, v in state_dict.items()))}


# the parameter groups each pipeline trains (deepsir_tpu/training.py:37-41).
# The optax state of its make_optimizer is multi_transform({"train":
# adam(schedule), "freeze": set_to_zero()}) over the params, a leaf "train"
# when any key of its path is in the pipeline's group; adam is chain(
# scale_by_adam (count, mu, nu), scale_by_schedule (count)), and a frozen
# leaf of mu and nu is stored as an empty map
TRAINABLE_GROUPS = {
    "label": {"feat_extractor"},
    "feat": {"mlp_feat", "mlp_att", "mlp_proj"},
    "align": {"inlier_model"},
}


def trainable_parameters(model: Network):
    """[(name, parameter)] of the leaves `model`'s pipeline trains, in
    `named_parameters` order."""
    group = TRAINABLE_GROUPS[model.pipeline]
    return [(name, p) for name, p in model.named_parameters()
            if group & set(flax_path(name)[0])]


def to_jax_opt_state(model: Network, optimizer: torch.optim.Optimizer) -> Dict:
    """The Adam state of `optimizer` (made by training.make_optimizer) as the
    JAX package's optax state tree: exp_avg -> mu, exp_avg_sq -> nu, step ->
    both int32 counts; frozen leaves of mu and nu are empty maps. Before the
    first step the moments are zero and the counts 0, as optax initialises
    them."""
    frozen = {flax_path(k)[0]: {} for k in model.state_dict()}
    mu, nu = dict(frozen), dict(frozen)
    count = 0
    for key, p in trainable_parameters(model):
        state = optimizer.state.get(p, {})
        path = flax_path(key)[0]
        for tree, name in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            tree[path] = _to_flax_leaf(key, state.get(name, torch.zeros_like(p)))[1]
        if "step" in state:
            count = int(state["step"])
    counts = np.asarray(count, np.int32)
    adam = {"count": counts, "mu": {"params": _nest(mu)}, "nu": {"params": _nest(nu)}}
    return {"inner_states": {"freeze": {"inner_state": {}},
                             "train": {"inner_state": {"0": adam,
                                                       "1": {"count": counts.copy()}}}}}


def load_jax_opt_state(opt_state: Mapping, model: Network,
                       optimizer: torch.optim.Optimizer) -> int:
    """Set `optimizer`'s Adam state from the JAX package's optax state tree
    (the layout `to_jax_opt_state` writes): mu -> exp_avg, nu -> exp_avg_sq,
    count -> step. Every trained leaf of the model's pipeline is read once
    and every frozen leaf must be an empty map; returns the count."""
    train = opt_state["inner_states"]["train"]["inner_state"]
    count = int(train["0"]["count"])
    if int(train["1"]["count"]) != count:
        raise ValueError(f"adam count {count} and schedule count "
                         f"{int(train['1']['count'])} differ")
    moments = {}
    for name in ("mu", "nu"):
        flat = _flatten(train["0"][name]["params"])
        for key, p in trainable_parameters(model):
            path, transpose = flax_path(key)
            arr = flat.pop(path, None)
            if not isinstance(arr, np.ndarray):
                raise ValueError(f"{name}: no moment at {'/'.join(path)}")
            arr = arr.T if transpose else arr
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name} {'/'.join(path)}: shape {arr.shape}, "
                                 f"parameter {tuple(p.shape)}")
            moments[(name, key)] = torch.tensor(arr, dtype=p.dtype, device=p.device)
        left = [p for p, v in flat.items() if not (isinstance(v, dict) and not v)]
        if left:
            raise ValueError(f"{name}: moments outside the {model.pipeline} groups "
                             f"{sorted(TRAINABLE_GROUPS[model.pipeline])}: {left[:3]}")
    names = {id(p): key for key, p in trainable_parameters(model)}
    for group in optimizer.param_groups:
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            key = names[id(p)]
            step = torch.tensor(float(count), dtype=torch.float32,
                                device=p.device if on_device else "cpu")
            optimizer.state[p] = {"step": step, "exp_avg": moments[("mu", key)],
                                  "exp_avg_sq": moments[("nu", key)]}
    return count

