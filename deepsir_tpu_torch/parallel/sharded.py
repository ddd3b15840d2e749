"""Data-parallel train and eval steps over a process mesh
(deepsir_tpu/parallel/sharded.py).

In the JAX package a step jitted over a batch sharded on the mesh's
``data`` axis computes what the single-device step computes on the whole
batch: XLA inserts the collectives. Here one process runs per card and
sees only its rows, so the steps are `training.train_step` and
`training.make_eval_step` given the mesh: every reduction over the batch
axis (the losses' means, the batch norm's statistics, the accuracies' counts,
the grads) is summed over the data axis, the dropout is drawn as one device
would draw it for the whole batch, and the skip guard's flag is reduced
over the mesh. Parameters and Adam state are replicated: `replicate_state`
makes every rank's copy the first rank's, and equal grads keep them equal.

A difference from the JAX package in multi-process runs: there every
process's loader yields the same `batch_size` pairs and `shard_batch`
treats them as process-local, so the global batch holds each pair once per
process (deepsir_tpu/parallel/sharded.py:40-43). Here `shard_batch` takes
the global batch and keeps this rank's rows, as JAX's single-process
branch does (:44-49): the same step, without the duplicate work.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.distributed as dist

from deepsir_tpu_torch.config import ModelConfig
from deepsir_tpu_torch.models.network import AlignOutput, Network
from deepsir_tpu_torch.parallel.matching import make_ring_matcher
from deepsir_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from deepsir_tpu_torch.training import check_data_parallel, make_eval_step, train_step


def shard_batch(mesh: Mesh, arrays: Dict) -> Dict:
    """This rank's rows of the global batch `arrays` (host arrays or
    tensors): the batch dim split over the data axis, in data order."""
    ndata = mesh.shape[DATA_AXIS]
    me = mesh.index(DATA_AXIS)
    out = {}
    for k, v in arrays.items():
        if v.shape[0] % ndata:
            raise ValueError(f"batch dim {v.shape[0]} of '{k}' not divisible by data axis "
                             f"{ndata}")
        rows = v.shape[0] // ndata
        out[k] = v[me * rows:(me + 1) * rows]
    return out


def _broadcast_(t: torch.Tensor, src: int, group) -> None:
    """Overwrite t with rank `src`'s t, through a contiguous buffer where t
    is not one; a CPU tensor (Adam's count) crosses an NCCL group through
    the current card."""
    device = t.device
    if dist.get_backend(group) == "nccl" and device.type != "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    buf = t.contiguous().to(device)
    dist.broadcast(buf, src=src, group=group)
    if buf is not t:
        t.copy_(buf)


@torch.no_grad()
def replicate_state(mesh: Mesh, model: Network,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Give every rank of the mesh its first rank's parameters and Adam
    state, in place. Each rank must already hold state of the same layout
    (the same seed or the same checkpoint)."""
    src = mesh.ranks[0][0]
    for t in model.state_dict().values():
        _broadcast_(t, src, mesh.group)
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                for value in optimizer.state.get(p, {}).values():
                    if isinstance(value, torch.Tensor):
                        _broadcast_(value, src, mesh.group)


def model_with_mesh_matcher(model: Network, mesh: Mesh) -> Network:
    """Route the align forward's correspondence search through the ring
    matcher when the mesh has a model axis (> 1 rank).

    Returns a shallow copy of `model` with `matcher` set: it shares the
    parameters and submodules, so a checkpoint trained on one device runs
    with the reference points split unchanged, and `model` itself keeps
    its search."""
    if mesh.shape[MODEL_AXIS] <= 1 or model.pipeline != "align":
        return model
    clone = copy.copy(model)
    clone.matcher = make_ring_matcher(mesh)
    return clone


def make_sharded_train_step(mesh: Mesh):
    """A drop-in for `training.train_step` on this rank's rows of the batch
    (`shard_batch`): step(model, optimizer, cfgs, arrays, generator,
    steps_per_epoch) -> the aux of the global batch's step. Every rank of
    the mesh calls it with the same state, and a generator seeded alike."""
    def step(model, optimizer, cfgs, arrays, generator, steps_per_epoch):
        return train_step(model_with_mesh_matcher(model, mesh), optimizer, cfgs, arrays,
                          generator, steps_per_epoch, mesh=mesh)
    return step


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's t of `group`, concatenated along `dim` in rank order."""
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=dim).to(t.dtype)


# AlignOutput's batch dim, by field
_BATCH_DIM = {"transforms": 1, "inlier_logits": 1, "pred_idx": 1}


def make_sharded_eval_step(model: Network, cfg: ModelConfig, mesh: Mesh,
                           num_iter: Optional[int] = None):
    """The align eval step on this rank's rows of the batch (`shard_batch`):
    arrays -> (transforms, AlignOutput) of the whole batch, every field
    gathered over the data axis, on every rank (JAX's out_shardings=None);
    `.device` as `training.make_eval_step`'s."""
    check_data_parallel(cfg)
    base = make_eval_step(model_with_mesh_matcher(model, mesh), cfg, num_iter,
                          group=mesh.data_group)

    def eval_step(arrays):
        _, out = base(arrays)
        out = AlignOutput(*(_gather(value, _BATCH_DIM.get(name, 0), mesh.data_group)
                            for name, value in out._asdict().items()))
        return out.transforms, out

    eval_step.device = base.device
    return eval_step
