"""Building-block layers, channel-last (deepsir_tpu/models/layers.py).

A 1x1 convolution is an `nn.Linear` over the last axis. GroupNorm follows
flax's channels-last semantics: statistics per sample (leading dim) and
group, over every other axis and the channels of the group, eps 1e-5, with
8 groups when C >= 64, else 4. `norm="batch"` is the JAX package's
stateless batch norm (deepsir_tpu/models/layers.py:66-76): per-channel
mean and biased variance over every non-channel axis of the call, eps 1e-5,
then a per-channel `scale` and `bias` held by the unit itself; no running
statistics, in training and inference alike. `norm="none"` drops the norm
(and its parameters), the layout of the FC stacks under `fc_norm="none"`.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

LEAKY_SLOPE = 0.2


def num_groups(channels: int) -> int:
    return 8 if channels >= 64 else 4


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return nn.functional.leaky_relu(x, LEAKY_SLOPE)


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
               eps: float = 1e-5) -> torch.Tensor:
    """Stateless batch norm of x (..., C): statistics per channel over every
    other axis of this call."""
    axes = tuple(range(x.dim() - 1))
    var, mean = torch.var_mean(x, dim=axes, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class ConvUnit(nn.Module):
    """Linear (+ norm) (+ LeakyReLU 0.2), the reference's MLP2D block.

    norm is "group", "batch" or "none". Under "batch" the unit's own `scale`
    and `bias` are the norm's affine (flax's `ConvUnit_i/scale`, `/bias`)."""

    def __init__(self, c_in: int, c_out: int, use_norm: bool = True,
                 use_act: bool = True, norm: str = "group"):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense(x)
        if self.norm is not None:
            x = self.norm(x)
        elif self.scale is not None:
            x = batch_norm(x, self.scale, self.bias)
        if self.use_act:
            x = leaky_relu(x)
        return x


class MLP(nn.Module):
    """Stack of ConvUnits; norm and activation after every layer but the last."""

    def __init__(self, c_in: int, channels: Sequence[int], norm: str = "group"):
        super().__init__()
        units = []
        for i, ch in enumerate(channels):
            last = i == len(channels) - 1
            units.append(ConvUnit(c_in, ch, use_norm=not last, use_act=not last, norm=norm))
            c_in = ch
        self.units = nn.ModuleList(units)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.units:
            x = unit(x)
        return x


class AttPooling(nn.Module):
    """Attentive pooling over the neighbour axis: (..., N, K, C) -> (..., N, d_out)."""

    def __init__(self, c_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(c_in, c_in, bias=False)
        self.unit = ConvUnit(c_in, d_out)

    def forward(self, feature_set: torch.Tensor) -> torch.Tensor:
        att = torch.softmax(self.dense(feature_set), dim=-2)   # over neighbours
        return self.unit(torch.sum(feature_set * att, dim=-2))
