"""Host batch -> device batch with both pyramids built on the device, the
label and feat serving forward, and the training step of all three
pipelines, and the align eval step (deepsir_tpu/training.py).

One step (`train_step`, as `make_train_step` defines it): `device_batch`,
the pipeline's loss (`compute_loss`: label the semantic CE of both clouds,
feat the circle and detector loss over `forward_pair`, align
`scan_alignment_loss` over `forward_align(train=True)` with
`num_train_reg_iter` iterations), backward, and Adam on the pipeline's
trainable groups only (the staged freeze, `utils.params.TRAINABLE_GROUPS`)
at the staircase-decayed learning rate. A non-finite loss or gradient, or
an invalid pose solve, skips the whole update: parameters, moments and
count stay as they were, and so does the learning rate, which follows the
count of applied updates.

Data parallelism (parallel/sharded.py drives it): given a `mesh`, each
process holds its rows of the global batch and an identical copy of the
state. Its loss is its share of the global loss (the losses' `group`), the
forward's batch norm and dropout span the data axis, the grads are summed
over the data axis (and the model axis's first rank's copy broadcast over
the model axis, so that replicas stay bit-equal), and the skip guard's flag
is all-reduced (MIN) over the mesh before its one host read: the step is
the single-device step on the global batch.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from deepsir_tpu_torch.config import LossConfig, ModelConfig, RunConfig, TrainConfig, \
    check_supported
from deepsir_tpu_torch.losses.align import scan_alignment_loss
from deepsir_tpu_torch.losses.detdes import det_des_loss
from deepsir_tpu_torch.losses.semantic import semantic_loss
from deepsir_tpu_torch.models.network import ForwardOptions, Network, PairBatch, PairOutput
from deepsir_tpu_torch.ops.pyramid import build_cloud_pyramid
from deepsir_tpu_torch.utils.collectives import ProcessGroup, global_sum
from deepsir_tpu_torch.utils.params import trainable_parameters
from deepsir_tpu_torch.utils.profiling import span

_KEYS = ("points_src", "points_ref", "transform_gt")
_MASKS = ("mask_src", "mask_ref")
_INDICES = ("matches", "num_matches", "labels_src", "labels_ref")


def _to_device(x, device) -> torch.Tensor:
    """A host array or tensor on `device` as fp32. Half-width payloads
    (float16, or bfloat16 as a torch tensor or an ml_dtypes numpy array)
    cross to the device as they are and are upcast there."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        if x.dtype.name == "bfloat16":           # numpy has no bf16 of its own
            x = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(x)
    return x.to(device=device).to(torch.float32)


def device_batch(cfg: ModelConfig, arrays: Dict[str, np.ndarray],
                 device="cuda") -> PairBatch:
    """Copy the pair arrays to `device` and build both clouds' pyramids there.

    Accepts `points_src`, `points_ref` (B, N, C) in fp32, fp16 or bf16 (the
    eval's `transfer_dtype`; upcast to fp32 on the device), `transform_gt`
    (B, 3, 4), optionally the validity masks `mask_src`, `mask_ref` (B, N),
    the ground-truth match lists `matches` (B, M_cap, 2), padded with -1,
    and `num_matches` (B,) of the list BCE, and the semantic labels
    `labels_src`, `labels_ref` (B, N) of the label loss (int32 on the
    device). Under `pyramid_order="morton"` the caller passes curve-sorted
    clouds (ops/morton.py::sort_clouds); this function does not sort.
    """
    check_supported(cfg)
    extra = sorted(set(arrays) - set(_KEYS) - set(_MASKS) - set(_INDICES))
    if extra:
        raise NotImplementedError(f"device_batch arrays {extra}")
    with span("deepsir.h2d"):
        src, ref = (_to_device(arrays[k], device) for k in ("points_src", "points_ref"))
        masks = {k: _to_device(arrays[k], device) for k in _MASKS if k in arrays}
        indices = {k: torch.as_tensor(arrays[k], device=device).to(torch.int32)
                   for k in _INDICES if k in arrays}
    pyramid_src = build_cloud_pyramid(cfg, src[..., :3])
    pyramid_ref = build_cloud_pyramid(cfg, ref[..., :3])
    with span("deepsir.h2d"):
        transform_gt = _to_device(arrays["transform_gt"], device)
    return PairBatch(points_src=src, points_ref=ref, pyramid_src=pyramid_src,
                     pyramid_ref=pyramid_ref, transform_gt=transform_gt, **masks, **indices)


def batch_arrays_only(batch: Dict) -> Dict[str, np.ndarray]:
    """A loader batch without its non-array entries (the metas)."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def lr_at(count: int, cfg: TrainConfig, steps_per_epoch: int) -> float:
    """The learning rate after `count` applied updates: `optax.exponential_decay`
    (staircase, end_value=lr_clip) over lr_decay_epoch epochs, as
    deepsir_tpu/training.py:50-57 builds it, evaluated in fp32 as optax does."""
    f32 = np.float32
    steps = max(1, cfg.lr_decay_epoch * steps_per_epoch)
    if count <= 0:
        value = f32(cfg.lr)
    else:
        p = np.floor(f32(count) / f32(steps))
        value = f32(cfg.lr) * np.power(f32(cfg.lr_decay_ratio), p, dtype=f32)
    clip = max if cfg.lr_decay_ratio < 1.0 else min
    return float(clip(f32(value), f32(cfg.lr_clip)))


def make_optimizer(model: Network) -> torch.optim.Adam:
    """Adam on the parameters that `model.pipeline` trains, and no other
    (`utils.params.TRAINABLE_GROUPS`; optax.adam's update: betas 0.9 / 0.999,
    eps 1e-8 outside the square root); its learning rate is set by
    `train_step` before each update."""
    return torch.optim.Adam([p for _, p in trainable_parameters(model)], lr=0.0,
                            betas=(0.9, 0.999), eps=1e-8)


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates applied so far (optax's count; torch keeps it per parameter)."""
    state = optimizer.state.get(optimizer.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def compute_loss(model: Network, loss_cfg: LossConfig, batch: PairBatch,
                 generator: Optional[torch.Generator] = None, group: ProcessGroup = None):
    """The loss of one training forward of `model.pipeline`
    (deepsir_tpu/training.py:compute_loss): (total, aux).

    label: `semantic_loss` of each cloud's logits, summed; aux {"loss",
    "acc" (the two accuracies' mean), "invalid"}. feat: `det_des_loss` over
    `forward_pair`; aux {"loss", "acc" (%), "invalid"}. align: the scan
    alignment loss; aux {"loss", "invalid", "losses", "pred_idx"}, its BCE
    labels from the match lists when the batch carries them, else from the
    geometric test. `invalid` is a device boolean (always false but for
    align's pose solves). With a data-parallel `group` the loss and its
    terms are this rank's shares of the global batch's (the accuracy is
    global already), and `invalid` and `pred_idx` are this rank's."""
    if model.pipeline != "align":
        with span("deepsir.train.forward"):
            out = model.forward_pair(batch, train=True, generator=generator, group=group)
            invalid = torch.zeros((), dtype=torch.bool, device=batch.points_src.device)
        with span("deepsir.train.loss"):
            if model.pipeline == "feat":
                loss, acc = det_des_loss(out.feat_src, out.feat_ref, out.xyz_src, out.xyz_ref,
                                         out.score_src, out.score_ref, batch.transform_gt,
                                         loss_cfg, group)
            else:
                if batch.labels_src is None or batch.labels_ref is None:
                    raise ValueError("the label loss needs labels_src and labels_ref")
                loss_s, acc_s = semantic_loss(out.logits_src, batch.labels_src, group)
                loss_r, acc_r = semantic_loss(out.logits_ref, batch.labels_ref, group)
                loss, acc = loss_s + loss_r, (acc_s + acc_r) / 2
        return loss, {"loss": loss, "acc": acc, "invalid": invalid}
    opts = ForwardOptions(num_iter=model.cfg.num_train_reg_iter)
    with span("deepsir.train.forward"):
        out = model.forward_align(batch, opts, train=True, generator=generator, group=group)
    with span("deepsir.train.loss"):
        use_lists = batch.matches is not None
        terms = scan_alignment_loss(out.transforms, out.inlier_logits, out.pred_idx,
                                    out.pt_src, batch.transform_gt, batch.matches, loss_cfg,
                                    pt_ref=None if use_lists else out.pt_ref,
                                    mask_src=batch.mask_src, group=group)
        total = terms.pop("total")
        invalid = out.invalid.any()
    return total, {"loss": total, "invalid": invalid, "losses": terms,
                   "pred_idx": out.pred_idx}


def check_data_parallel(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for an option that a data-parallel mesh does
    not run: `randla_norm="batch"`, whose statistics would span this rank's
    rows only (the RandLA units take no data-parallel group)."""
    if cfg.randla_norm == "batch":
        raise NotImplementedError("ModelConfig.randla_norm='batch' is not ported to a "
                                  "data-parallel mesh (the port implements it on one device)")


def train_step(model: Network, optimizer: torch.optim.Optimizer, cfgs: RunConfig,
               arrays: Dict[str, np.ndarray], generator: Optional[torch.Generator],
               steps_per_epoch: int, mesh=None) -> Dict:
    """One training step of `model.pipeline` (which must be
    `cfgs.pipeline`) on the device of `model`'s parameters.

    `mesh` (a parallel.mesh.Mesh; None on one device): `arrays` are this
    rank's rows of the global batch, and the step is the global batch's
    (module docstring); the returned loss, terms, accuracy, `invalid`,
    grads and `skipped` are global, `pred_idx` this rank's rows. Dropout
    draws from `generator` as one device would for the global batch, so
    every rank seeds it alike.

    Returns compute_loss's aux with its tensors detached ("losses" and
    "pred_idx" under align, "acc" under label and feat), and "loss",
    "invalid", "grads" (the trained parameters' grads by parameter name,
    None where none was computed), "lr" (of this step) and "skipped". The
    skip guard reads one device boolean on the host per step; the training
    step is not captured in a CUDA graph.
    """
    if model.pipeline != cfgs.pipeline:
        raise ValueError(f"a {model.pipeline} network under a {cfgs.pipeline} run config")
    if mesh is not None:
        check_data_parallel(cfgs.model)
    device = next(model.parameters()).device
    batch = device_batch(cfgs.model, arrays, device=device)
    optimizer.zero_grad(set_to_none=True)
    loss, aux = compute_loss(model, cfgs.loss, batch, generator,
                             None if mesh is None else mesh.data_group)
    named = trainable_parameters(model)
    with span("deepsir.train.backward"):
        loss.backward()
        if mesh is not None:
            _reduce_grads([p.grad for _, p in named if p.grad is not None], mesh)
            aux = _global_aux(aux, mesh.data_group)
            loss = aux["loss"]
    with span("deepsir.train.guard"):
        ok = torch.isfinite(loss.detach()) & ~aux["invalid"]
        for _, p in named:
            if p.grad is not None:
                ok = ok & torch.isfinite(p.grad).all()
        if mesh is not None:
            # one rank's non-finite grad or failed solve skips the step everywhere
            ok = ok.to(torch.int32)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group)
        applied = bool(ok)                              # the step's one host read
    lr = lr_at(adam_count(optimizer), cfgs.train, steps_per_epoch)
    if applied:
        with span("deepsir.train.optimizer"):
            for group in optimizer.param_groups:
                group["lr"] = lr
            optimizer.step()
    out = {k: v.detach() for k, v in aux.items() if k != "losses"}
    if "losses" in aux:
        out["losses"] = {k: v.detach() for k, v in aux["losses"].items()}
    return dict(out, grads={n: p.grad for n, p in named}, lr=lr, skipped=not applied)


def _reduce_grads(grads, mesh) -> None:
    """Sum `grads` over the mesh's data axis in one flat all-reduce, then
    give every rank of the model axis its first rank's sums."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    if len(mesh.model_ranks) > 1:
        dist.broadcast(flat, src=mesh.model_ranks[0], group=mesh.model_group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _global_aux(aux: Dict, group) -> Dict:
    """compute_loss's aux with the loss, its terms and `invalid` of the
    global batch: the shares summed over `group`, in one all-reduce."""
    terms = aux.get("losses", {})
    shares = torch.stack([aux["loss"].detach()] + [v.detach() for v in terms.values()]
                         + [aux["invalid"].to(aux["loss"].dtype)])
    total = global_sum(shares, group)
    out = dict(aux, loss=total[0], invalid=total[-1] > 0)
    if terms:
        out["losses"] = dict(zip(terms, total[1:-1]))
    return out


@torch.no_grad()
def forward_step(model: Network, cfg: ModelConfig, arrays: Dict[str, np.ndarray]
                 ) -> PairOutput:
    """The label and feat serving path (deepsir_tpu/training.py:
    make_forward_step): `device_batch` on the device of `model`'s
    parameters, then `forward_pair` in inference, without a graph."""
    device = next(model.parameters()).device
    return model.forward_pair(device_batch(cfg, arrays, device=device))


def make_eval_step(model: Network, cfg: ModelConfig, num_iter: Optional[int] = None,
                   refine_stride: int = 1, group: ProcessGroup = None):
    """The align eval step (deepsir_tpu/training.py:make_eval_step): arrays ->
    (transforms (iters, B, 3, 4), AlignOutput), as `device_batch` and
    `forward_align` with clip_weight on, `num_iter` iterations
    (cfg.num_reg_iter if None) and `refine_stride`, without a graph, on the
    device of `model`'s parameters, which the step keeps as `.device`.
    `group`: the data-parallel group the forward's batch spans
    (parallel/sharded.py::make_sharded_eval_step)."""
    opts = ForwardOptions(num_iter=num_iter or cfg.num_reg_iter, clip_weight=True,
                          refine_stride=refine_stride)
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(arrays):
        out = model.forward_align(device_batch(cfg, arrays, device=device), opts, group=group)
        return out.transforms, out

    eval_step.device = device
    return eval_step
