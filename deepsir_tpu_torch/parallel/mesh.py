"""The (data, model) process mesh (deepsir_tpu/parallel/mesh.py).

One process runs per card. `make_mesh` lays the first `num_data *
num_model` ranks of the process group out as a (data, model) grid, row by
row, as the JAX package lays out devices:

  * ``data``  — data parallelism over registration pairs (the batch dim):
    each rank of a column holds its rows of the global batch, and the
    grads and the batch-wide reductions are summed over the column;
  * ``model`` — the reference cloud's points split over the ranks of a
    row, whose correspondence search rotates the shards around the row
    (parallel/matching.py).

The mesh gives each rank its coordinates and the process groups of its
column (`data_group`) and of its row (`model_group`). JAX's sharding specs
`batch_sharding` and `replicated` have no torch object: their counterparts
are `parallel.sharded.shard_batch`'s slice of the batch and
`parallel.sharded.replicate_state`'s broadcast of the state.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh(NamedTuple):
    """A (data, model) grid of ranks, as seen by one rank."""
    shape: Dict[str, int]                 # {DATA_AXIS: num_data, MODEL_AXIS: num_model}
    ranks: Tuple[Tuple[int, ...], ...]    # the grid of global ranks, (num_data, num_model)
    coords: Optional[Tuple[int, int]]     # this rank's (data, model) place; None: outside
    group: Optional["dist.ProcessGroup"]        # every rank of the grid
    data_group: Optional["dist.ProcessGroup"]   # this rank's column
    model_group: Optional["dist.ProcessGroup"]  # this rank's row

    @property
    def data_ranks(self) -> List[int]:
        """The global ranks of this rank's column, in data order."""
        return [row[self._coords()[1]] for row in self.ranks]

    @property
    def model_ranks(self) -> List[int]:
        """The global ranks of this rank's row, in model order."""
        return list(self.ranks[self._coords()[0]])

    def index(self, axis: str) -> int:
        """This rank's place along `axis`."""
        return self._coords()[(DATA_AXIS, MODEL_AXIS).index(axis)]

    def axis_group(self, axis: str) -> "dist.ProcessGroup":
        return self.data_group if axis == DATA_AXIS else self.model_group

    def axis_ranks(self, axis: str) -> List[int]:
        return self.data_ranks if axis == DATA_AXIS else self.model_ranks

    def _coords(self) -> Tuple[int, int]:
        if self.coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is outside the "
                               f"{self.shape[DATA_AXIS]}x{self.shape[MODEL_AXIS]} mesh")
        return self.coords


def make_mesh(num_data: int = -1, num_model: int = 1) -> Mesh:
    """Build a 2D (data, model) mesh over the ranks of the default process
    group (parallel.distributed.initialize_from_env starts it).

    num_data == -1 takes every rank not claimed by the model axis. Every
    rank of the process group calls this, in the same order as the others,
    since each process group is made by all of them (`dist.new_group`).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start one process per card "
                           "and call parallel.distributed.initialize_from_env()")
    world = dist.get_world_size()
    if num_model < 1:
        num_model = 1
    if num_data == -1:
        num_data = world // num_model
    if num_data < 1 or num_data * num_model > world:
        raise ValueError(f"mesh {num_data}x{num_model} needs more than the {world} ranks "
                         "of the process group")
    grid = tuple(tuple(d * num_model + m for m in range(num_model)) for d in range(num_data))
    group = dist.new_group(list(range(num_data * num_model)))
    columns = [dist.new_group([row[m] for row in grid]) for m in range(num_model)]
    rows = [dist.new_group(list(row)) for row in grid]
    rank = dist.get_rank()
    if rank >= num_data * num_model:
        return Mesh({DATA_AXIS: num_data, MODEL_AXIS: num_model}, grid, None, None, None, None)
    d, m = divmod(rank, num_model)
    return Mesh({DATA_AXIS: num_data, MODEL_AXIS: num_model}, grid, (d, m), group,
                columns[m], rows[d])
