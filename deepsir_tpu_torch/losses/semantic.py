"""Semantic segmentation loss and the mIoU metric (deepsir_tpu/losses/semantic.py).

Inverse-frequency-weighted cross entropy over the valid points, with the
ignored points' weights zeroed (the shapes stay static); the confusion
matrix is an integer scatter-add on the device, accumulated across batches
by `SemanticMetric` on the host.

Over a data-parallel `group` (the batch split across processes) the loss
is this rank's share of the global weighted mean, sum(nll * w) over its rows
divided by the global sum(w): ignored labels make w differ from pair to
pair, so a mean of the ranks' means would be another function. The shares
sum to the single-device loss; the accuracy is the global one.

Label convention: raw labels are SemanticKITTI learning-map ids 0..19, 0
'unlabeled' (ignored); the logits have 19 classes, for ids 1..19.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deepsir_tpu_torch.utils.collectives import ProcessGroup, global_sum

NUM_CLASSES = 19

# points per class in SemanticKITTI, for inverse-frequency CE weights
_NUM_PER_CLASS = np.array([
    55437630, 320797, 541736, 2578735, 3274484, 552662, 184064, 78858,
    240942562, 17294618, 170599734, 6369672, 230413074, 101130274, 476491114,
    9833174, 129609852, 4506626, 1168181], dtype=np.float64)
_freq = _NUM_PER_CLASS / _NUM_PER_CLASS.sum()
CLASS_WEIGHTS = np.asarray(1.0 / (_freq + 0.02), dtype=np.float32)

LABEL_NAMES = (
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign")

_CLASS_WEIGHTS = {}                     # CLASS_WEIGHTS by device


def _class_weights(device) -> torch.Tensor:
    """CLASS_WEIGHTS on `device`, copied there once: a copy from the host in
    every step would wait for the device, and cannot be captured in a CUDA
    graph."""
    weights = _CLASS_WEIGHTS.get(device)
    if weights is None:
        weights = _CLASS_WEIGHTS[device] = torch.as_tensor(CLASS_WEIGHTS, device=device)
    return weights


def _target(labels: torch.Tensor):
    """(valid mask, class index 0..18) of raw labels."""
    labels = labels.long()
    return labels > 0, torch.clamp(labels - 1, 0, NUM_CLASSES - 1)


def semantic_loss(logits: torch.Tensor, labels: torch.Tensor, group: ProcessGroup = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted CE over the valid points, and the accuracy (a fraction).

    logits (..., N, 19), labels (..., N) raw ids in 0..19 (0 ignored) ->
    (scalar loss, scalar accuracy); with a `group`, this rank's share of
    the loss and the global accuracy (module docstring).
    """
    valid, target = _target(labels)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    weights = _class_weights(logits.device)[target] * valid
    loss = torch.sum(nll * weights) / (global_sum(torch.sum(weights), group) + 1e-12)
    correct = (torch.argmax(logits, dim=-1) == target) & valid
    counts = global_sum(torch.stack([torch.sum(correct), torch.sum(valid)]), group)
    acc = counts[0] / (counts[1] + 1e-12)
    return loss, acc


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(19, 19) int32 counts over the valid points: rows the ground truth,
    columns the prediction."""
    valid, target = _target(labels)
    flat = (target * NUM_CLASSES + torch.argmax(logits, dim=-1)).reshape(-1)
    cm = torch.zeros(NUM_CLASSES * NUM_CLASSES, dtype=torch.int32, device=logits.device)
    cm.index_add_(0, flat, valid.reshape(-1).to(torch.int32))
    return cm.reshape(NUM_CLASSES, NUM_CLASSES)


class SemanticMetric:
    """Host-side accumulator of confusion matrices: mIoU and accuracy across
    batches."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.cm = np.zeros((NUM_CLASSES, NUM_CLASSES), dtype=np.int64)

    def update(self, cm_batch) -> None:
        if isinstance(cm_batch, torch.Tensor):
            cm_batch = cm_batch.cpu().numpy()
        self.cm += np.asarray(cm_batch, dtype=np.int64)

    def compute(self):
        """(mean IoU over the 19 classes, per-class IoU list, accuracy); resets."""
        gt = self.cm.sum(axis=1)
        pos = self.cm.sum(axis=0)
        tp = np.diagonal(self.cm)
        denom = gt + pos - tp
        iou = np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
        mean_iou = float(iou.sum() / NUM_CLASSES)
        total = self.cm.sum()
        mean_acc = float(tp.sum() / total) if total > 0 else 0.0
        self.reset()
        return mean_iou, iou.tolist(), mean_acc
