"""Building-block layers, channel-last (deepsir_tpu/models/layers.py).

A 1x1 convolution is an `nn.Linear` over the last axis. GroupNorm follows
flax's channels-last semantics: statistics per sample (leading dim) and
group, over every other axis and the channels of the group, eps 1e-5, with
8 groups when C >= 64, else 4. `norm="batch"` is the JAX package's
stateless batch norm (deepsir_tpu/models/layers.py:66-76): per-channel
mean and biased variance over every non-channel axis of the call, eps 1e-5,
then a per-channel `scale` and `bias` held by the unit itself; no running
statistics, in training and inference alike. When the batch is split over
the ranks of a data-parallel `group`, the statistics are the global batch's
(sums all-reduced, gradient included), as XLA computes them on a sharded
batch. `norm="none"` drops the norm
(and its parameters), the layout of the FC stacks under `fc_norm="none"`.

Mixed precision (deepsir_tpu/models/layers.py:25-27): a unit built with
`dtype=torch.bfloat16` computes its Dense as flax's bf16 `Dense` does
(`dense`): input and weight rounded to bf16, the product in bf16 with fp32
sums, then the bias, rounded to bf16, added in bf16. Its norm or, without
one, its output is fp32, and so are the softmax of `AttPooling` and every
activation between units. Parameters stay fp32. `dtype=None` is fp32 with
no casts.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from deepsir_tpu_torch.utils.collectives import ProcessGroup, global_sum_grad, group_size

LEAKY_SLOPE = 0.2


def num_groups(channels: int) -> int:
    return 8 if channels >= 64 else 4


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """A config's compute dtype name -> the Dense layers' dtype (None: fp32)."""
    return None if name == "float32" else getattr(torch, name)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax `Dense(dtype=dtype)` with `layer`'s parameters. Under a half
    dtype the bias is added after the product is rounded (two roundings,
    as flax does), not fused into it as `F.linear` would."""
    if dtype is None:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class GroupNorm(nn.Module):
    """Channels-last GroupNorm over x (B, ..., C) with per-channel affine."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xg = x.reshape(b, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
        y = (xg - mean) * torch.rsqrt(var + self.eps)
        return y.reshape(x.shape) * self.weight + self.bias


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, group: ProcessGroup = None) -> torch.Tensor:
    """Stateless batch norm of x (..., C): statistics per channel over every
    other axis of this call, and over every rank of `group` (two passes:
    the mean, then the mean squared deviation from it)."""
    axes = tuple(range(x.dim() - 1))
    if group is None:
        var, mean = torch.var_mean(x, dim=axes, unbiased=False, keepdim=True)
    else:
        count = x[..., 0].numel() * group_size(group)
        mean = global_sum_grad(x.sum(dim=axes, keepdim=True), group) / count
        var = global_sum_grad(((x - mean) ** 2).sum(dim=axes, keepdim=True), group) / count
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class ConvUnit(nn.Module):
    """Linear (+ norm) (+ LeakyReLU 0.2), the reference's MLP2D block.

    norm is "group", "batch" or "none". Under "batch" the unit's own `scale`
    and `bias` are the norm's affine (flax's `ConvUnit_i/scale`, `/bias`)."""

    def __init__(self, c_in: int, c_out: int, use_norm: bool = True,
                 use_act: bool = True, norm: str = "group",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if norm not in ("group", "batch", "none"):
            raise NotImplementedError(f"ConvUnit norm={norm!r}")
        self.dense = nn.Linear(c_in, c_out)
        self.norm = (GroupNorm(num_groups(c_out), c_out)
                     if use_norm and norm == "group" else None)
        if use_norm and norm == "batch":
            self.scale = nn.Parameter(torch.ones(c_out))
            self.bias = nn.Parameter(torch.zeros(c_out))
        else:
            self.scale = self.bias = None
        self.use_act = use_act
        self.dtype = dtype

    def forward(self, x: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
        """`group`: the data-parallel group whose batch a batch norm spans."""
        x = dense(self.dense, x, self.dtype).float()    # the norm runs in fp32
        if self.norm is not None:
            x = self.norm(x)
        elif self.scale is not None:
            x = batch_norm(x, self.scale, self.bias, group=group)
        if self.use_act:
            x = leaky_relu(x)
        return x


class MLP(nn.Module):
    """Stack of ConvUnits; norm and activation after every layer but the last."""

    def __init__(self, c_in: int, channels: Sequence[int], norm: str = "group",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        units = []
        for i, ch in enumerate(channels):
            last = i == len(channels) - 1
            units.append(ConvUnit(c_in, ch, use_norm=not last, use_act=not last, norm=norm,
                                  dtype=dtype))
            c_in = ch
        self.units = nn.ModuleList(units)

    def forward(self, x: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
        for unit in self.units:
            x = unit(x, group)
        return x


class AttPooling(nn.Module):
    """Attentive pooling over the neighbour axis: (..., N, K, C) -> (..., N, d_out)."""

    def __init__(self, c_in: int, d_out: int, dtype: Optional[torch.dtype] = None,
                 norm: str = "group"):
        super().__init__()
        self.dense = nn.Linear(c_in, c_in, bias=False)
        self.unit = ConvUnit(c_in, d_out, norm=norm, dtype=dtype)
        self.dtype = dtype

    def forward(self, feature_set: torch.Tensor) -> torch.Tensor:
        scores = dense(self.dense, feature_set, self.dtype).float()
        att = torch.softmax(scores, dim=-2)                    # over neighbours
        return self.unit(torch.sum(feature_set * att, dim=-2))
