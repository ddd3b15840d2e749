"""Host batch -> device batch with both pyramids built on the device, and
the align training step (deepsir_tpu/training.py).

One step (`train_step`, as `make_train_step` defines it): `device_batch`,
`forward_align(train=True)` over `num_train_reg_iter` iterations,
`scan_alignment_loss`, backward into the inlier net, and Adam on the
`inlier_model` parameters only (the staged freeze of the align stage) at
the staircase-decayed learning rate. A non-finite loss or gradient, or an
invalid pose solve, skips the whole update: parameters, moments and count
stay as they were, and so does the learning rate, which follows the count
of applied updates.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deepsir_tpu_torch.config import LossConfig, ModelConfig, RunConfig, TrainConfig, \
    check_supported
from deepsir_tpu_torch.losses.align import scan_alignment_loss
from deepsir_tpu_torch.models.network import ForwardOptions, Network, PairBatch
from deepsir_tpu_torch.ops.pyramid import build_cloud_pyramid
from deepsir_tpu_torch.utils.params import TRAINABLE

_KEYS = ("points_src", "points_ref", "transform_gt")
_MASKS = ("mask_src", "mask_ref")
_MATCHES = ("matches", "num_matches")


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
    (B, 3, 4), optionally the validity masks `mask_src`, `mask_ref` (B, N)
    and the ground-truth match lists `matches` (B, M_cap, 2), padded with -1,
    and `num_matches` (B,) of the list BCE; labels are not ported. Under
    `pyramid_order="morton"` the caller passes curve-sorted clouds
    (ops/morton.py::sort_clouds); this function does not sort.
    """
    check_supported(cfg)
    extra = sorted(set(arrays) - set(_KEYS) - set(_MASKS) - set(_MATCHES))
    if extra:
        raise NotImplementedError(f"device_batch arrays {extra}")
    src, ref = (_to_device(arrays[k], device) for k in ("points_src", "points_ref"))
    masks = {k: _to_device(arrays[k], device) for k in _MASKS if k in arrays}
    matches = {k: torch.as_tensor(arrays[k], device=device).to(torch.int32)
               for k in _MATCHES if k in arrays}
    return PairBatch(
        points_src=src, points_ref=ref,
        pyramid_src=build_cloud_pyramid(cfg, src[..., :3]),
        pyramid_ref=build_cloud_pyramid(cfg, ref[..., :3]),
        transform_gt=_to_device(arrays["transform_gt"], device), **masks, **matches)


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
    """Adam on the inlier net's parameters only (optax.adam's update: betas
    0.9 / 0.999, eps 1e-8 outside the square root); its learning rate is set
    by `train_step` before each update."""
    return torch.optim.Adam(getattr(model, TRAINABLE).parameters(), lr=0.0,
                            betas=(0.9, 0.999), eps=1e-8)


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates applied so far (optax's count; torch keeps it per parameter)."""
    state = optimizer.state.get(optimizer.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def compute_loss(model: Network, loss_cfg: LossConfig, batch: PairBatch,
                 generator: Optional[torch.Generator] = None):
    """The align loss of one training forward (deepsir_tpu/training.py:
    compute_loss): (total, {"loss", "invalid", "losses"}). The BCE labels
    come from the match lists when the batch carries them, else from the
    geometric test."""
    opts = ForwardOptions(num_iter=model.cfg.num_train_reg_iter)
    out = model.forward_align(batch, opts, train=True, generator=generator)
    use_lists = batch.matches is not None
    terms = scan_alignment_loss(out.transforms, out.inlier_logits, out.pred_idx, out.pt_src,
                                batch.transform_gt, batch.matches, loss_cfg,
                                pt_ref=None if use_lists else out.pt_ref,
                                mask_src=batch.mask_src)
    total = terms.pop("total")
    return total, {"loss": total, "invalid": out.invalid.any(), "losses": terms,
                   "pred_idx": out.pred_idx}


def train_step(model: Network, optimizer: torch.optim.Optimizer, cfgs: RunConfig,
               arrays: Dict[str, np.ndarray], generator: Optional[torch.Generator],
               steps_per_epoch: int) -> Dict:
    """One align training step on the device of `model`'s parameters.

    Returns {"loss", "losses" (per-iteration terms), "invalid", "pred_idx"
    (iters, B, N), "grads" (the inlier grads by parameter name, None if
    none was computed), "lr" (of this step), "skipped"}. The skip guard
    reads one device boolean on the host per step; the training step is
    not captured in a CUDA graph.
    """
    device = next(model.parameters()).device
    batch = device_batch(cfgs.model, arrays, device=device)
    optimizer.zero_grad(set_to_none=True)
    loss, aux = compute_loss(model, cfgs.loss, batch, generator)
    loss.backward()
    named = list(getattr(model, TRAINABLE).named_parameters())
    ok = torch.isfinite(loss.detach()) & ~aux["invalid"]
    for _, p in named:
        if p.grad is not None:
            ok = ok & torch.isfinite(p.grad).all()
    applied = bool(ok)                                  # the step's one host read
    lr = lr_at(adam_count(optimizer), cfgs.train, steps_per_epoch)
    if applied:
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
    return {"loss": loss.detach(), "losses": {k: v.detach() for k, v in aux["losses"].items()},
            "invalid": aux["invalid"], "pred_idx": aux["pred_idx"],
            "grads": {n: p.grad for n, p in named}, "lr": lr, "skipped": not applied}
