"""The numbers that decide `correct`: what the timed path produced against
the plain reference on the same inputs and weights (each number's limit is
in `limits/<cell>.json`; how the limits were set is in PERF.md).

Registration (the eval driver), per checked batch:
- `pyramid_mismatch`: index entries of both clouds' pyramids (neighbours,
  pooling, upsampling) that differ; an exact comparison.
- `backbone_gap`: the largest difference of the backbone's features and
  logits, each over its tensor's largest magnitude.
- `score_gap`: the same for the keypoint scores.
- `match_share`: the share of correspondences, over all iterations, that
  differ.
- `weight_gap`: the mean difference of the inlier weights (sigmoid of the
  inlier logits) over all iterations.
- `transform_gap`: the largest difference of any iteration's transform of
  any serving: rotation entries, translations over the clouds' scale (10);
  infinite where `invalid` differs or a transform is not finite.

Training (the train driver), over the first three steps:
- `loss_gap`: the largest difference of a step's loss or loss term, over
  that step's reference loss.
- `grad_gap`: per trained leaf, the gap between the norms of the program's
  first gradient (from its Adam state after one step) and the reference's,
  over the larger of that leaf's reference norm and the median leaf's; the
  worst leaf.
- `change_gap`: the same for the norm of each leaf's change over the three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (the others move under Adam by round-off alone).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

CLOUD_SCALE = 10.0              # the clouds' coordinate scale (normal x 10)
LEAF_FLOOR = 1e-3               # leaves below this share of the median gradient
INF = float("inf")


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double()
    scale = float(want.abs().max().clamp_min(1e-30))
    return float((got.double() - want).abs().max()) / scale


def pyramid_mismatch(got: Sequence, want: Sequence) -> int:
    """Differing entries over two lists of index tensors."""
    return int(sum(int((a.to(b.device) != b).sum()) for a, b in zip(got, want, strict=True)))


def pyramid_indices(pyramid) -> List[torch.Tensor]:
    """A pyramid's index tensors: neighbours, pooling, upsampling per level."""
    return list(pyramid.neigh_idx) + list(pyramid.pool_idx) + list(pyramid.interp_idx)


def pose_gaps(got: np.ndarray, got_invalid: np.ndarray, want: np.ndarray,
              want_invalid: np.ndarray) -> np.ndarray:
    """(iters, B, 3, 4) transforms of one serving against the reference's:
    (iters, B) gaps, each the largest of the rotation entries' differences
    and the translation's over the clouds' scale; infinite for a pair whose
    `invalid` differs or whose transform is not finite."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    gap = np.maximum(d[..., :3].max(axis=(-2, -1)), d[..., 3].max(axis=-1) / CLOUD_SCALE)
    bad = ~np.isfinite(got).all(axis=(-2, -1)) | (got_invalid != want_invalid)[None, :]
    return np.where(bad, INF, gap)


def registration(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The registration numbers of one checked batch. `prog` and `ref` hold
    "pyramid" (index tensors), "feat", "logits", "score", "pred_idx",
    "inlier_logits" (tensors) and "servings" (a list of (transforms,
    invalid) numpy pairs; the reference's has one)."""
    want_t, want_inv = ref["servings"][0]
    gaps = [pose_gaps(t, inv, want_t, want_inv) for t, inv in prog["servings"]]
    match = (prog["pred_idx"].to(ref["pred_idx"].device) != ref["pred_idx"])
    w_got = torch.sigmoid(prog["inlier_logits"].double())
    w_want = torch.sigmoid(ref["inlier_logits"].double())
    return {
        "pyramid_mismatch": float(pyramid_mismatch(prog["pyramid"], ref["pyramid"])),
        "backbone_gap": max(_rel_max(prog["feat"], ref["feat"]),
                            _rel_max(prog["logits"], ref["logits"])),
        "score_gap": _rel_max(prog["score"], ref["score"]),
        "match_share": float(match.double().mean()),
        "weight_gap": float((w_got - w_want.to(w_got.device)).abs().mean()),
        "transform_gap": max(float(g.max()) for g in gaps),
    }


def worst(numbers: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst value over several batches."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    floor = float(np.median([want[n] for n in leaves]))
    return max(abs(got[n] - want[n]) / max(want[n], floor, 1e-30) for n in leaves)


def training(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The training numbers. Each side holds "terms" (one dict of floats per
    step, "total" among them), "grad_norms" (leaf -> the first step's
    gradient norm) and "change_norms" (leaf -> the norm of its change over
    the steps); the reference also "applied" (per step)."""
    loss = 0.0
    for got, want in zip(prog["terms"], ref["terms"], strict=True):
        scale = max(abs(want["total"]), 1e-30)
        for key in want:
            loss = max(loss, abs(got.get(key, INF) - want[key]) / scale)
    if not all(ref["applied"]) or not all(prog["applied"]):
        loss = INF
    leaves = list(ref["grad_norms"])
    median = float(np.median([ref["grad_norms"][n] for n in leaves]))
    moving = [n for n in leaves if ref["grad_norms"][n] >= LEAF_FLOOR * median]
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog["grad_norms"], ref["grad_norms"], leaves),
            "change_gap": _leaf_gap(prog["change_norms"], ref["change_norms"], moving)}
