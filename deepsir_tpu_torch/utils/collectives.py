"""Reductions over the batch axis when the batch is split across processes.

The JAX package gets global-batch semantics from XLA: a step jitted over a
batch sharded on the mesh's `data` axis computes what the single-device step
computes on the whole batch (deepsir_tpu/parallel/sharded.py). Under
`torch.distributed` each process sees only its rows, so every reduction over
the batch axis takes the process group of the data axis explicitly: `group`
None (one device) leaves the reduction as it was. Importing this module
starts no process group.

- `share_mean`: this rank's share of a mean over the global batch, so that
  the shares sum to the mean; its gradient is this rank's part of the
  global gradient, which the train step sums over the group.
- `global_sum` / `global_mean`: values every rank needs whole (counts,
  accuracies, aux), without a graph.
- `global_sum_grad`: a sum that carries the gradient to every rank's inputs
  (`torch.distributed.nn.functional.all_reduce`), for the batch norm's
  statistics.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

ProcessGroup = Optional["dist.ProcessGroup"]


def group_size(group: ProcessGroup) -> int:
    """The ranks of `group` (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: ProcessGroup) -> int:
    """This process's place in `group` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


def global_sum(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """x summed over the ranks of `group`, as a new tensor without a graph
    (x itself without a group)."""
    if group is None:
        return x
    x = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def global_sum_grad(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """x summed over the ranks of `group`; the backward sums the upstream
    gradients over the ranks too, so each rank's inputs get the gradient of
    the sum of every rank's loss."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, group=group)


def share_mean(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """The mean of x over every entry of the global batch, as this rank's
    share: x.sum() over the global count (x.mean() without a group). Every
    rank holds the same number of entries."""
    if group is None:
        return x.mean()
    return x.sum() / (x.numel() * group_size(group))


@torch.no_grad()
def global_mean(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """The mean of x over every entry of the global batch, on every rank."""
    if group is None:
        return x.mean()
    return global_sum(x.sum(), group) / (x.numel() * group_size(group))
