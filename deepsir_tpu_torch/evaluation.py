"""The eval harness (deepsir_tpu/evaluation.py): the timed align inference
sweep with its success statistics (`inference_align`), the optional pose
refiners (`pose_optimization`), the per-iteration metric sweep
(`evaluate_align`), its artifacts (`save_eval_align`) and the feat and
label inference sweeps with their dumps.

The refiners run on the device of the poses they refine, in the JAX
package's order: the chordal mean of the last iterations' poses, then
RANSAC over the last correspondences (which ignores the pose before it),
then 200 Adam steps on the 6D rotation and translation from the current
pose, then 30 iterations of ICP over the full clouds (kernel K1 at k=1 on
the card). All four are off by default.

The inference sweep's clock runs from the eval step's call to a
`torch.cuda.synchronize()` (on a CUDA device) after it; the first batch is
run once untimed before (warm-up); the refiners stay outside the clock. A
step from `training.make_eval_step` binds its model, so the sweeps take no
params, and the feat and label sweeps take any `arrays -> PairOutput`
callable, such as `functools.partial(training.forward_step, model, cfg)`.
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deepsir_tpu_torch.config import RunConfig
from deepsir_tpu_torch.losses.semantic import LABEL_NAMES, SemanticMetric, confusion_matrix
from deepsir_tpu_torch.math import se3_np
from deepsir_tpu_torch.ops.gather import gather_points
from deepsir_tpu_torch.ops.icp import icp
from deepsir_tpu_torch.ops.ransac import ransac_correspondence
from deepsir_tpu_torch.utils.metrics import (compute_metrics, print_metrics, rte_rre,
                                             summarize_metrics)
from deepsir_tpu_torch.utils.prefetch import device_prefetch, to_device
from deepsir_tpu_torch.utils.xlsx import write_xlsx

_logger = logging.getLogger("eval")
_EPS = 1e-16
FINETUNE_STEPS = 200
FINETUNE_LR = 0.1
ICP_ITERS = 30
RANSAC_HYPOTHESES = 4096


def _fence(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# Pose refiners
# --------------------------------------------------------------------------

def _rot6d_to_matrix(rot6d: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt of the 6D rotation (..., 6) -> (..., 3, 3), columns b1, b2, b3."""
    a1, a2 = rot6d[..., :3], rot6d[..., 3:]
    b1 = a1 / (torch.linalg.vector_norm(a1, dim=-1, keepdim=True) + 1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / (torch.linalg.vector_norm(b2, dim=-1, keepdim=True) + 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def _smooth_l1(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor,
               quantization_size: float, delta: float = 1.0) -> torch.Tensor:
    """Weighted high-dimensional smooth L1 of each pair: x, y (..., N, 3),
    weights (..., N) -> (...)."""
    sq = torch.sum(((x - y) / quantization_size) ** 2, dim=-1)
    use_sq = 0.5 * (sq < delta).to(x.dtype)
    loss = (0.5 - use_sq) * (torch.sqrt(sq + 1e-7) - 0.5 * delta ** 2) + use_sq * sq
    return torch.sum(loss * weights, dim=-1) / (torch.sum(weights, dim=-1) + 1e-12)


def finetune_pose(xyz_src: torch.Tensor, xyz_ref: torch.Tensor, pose: torch.Tensor,
                  weights: torch.Tensor, quantization_size: float,
                  max_iter: int = FINETUNE_STEPS) -> torch.Tensor:
    """Adam on the 6D rotation and the translation of each pose.

    xyz_src, xyz_ref (B, N, 3) matched points, pose (B, 3, 4), weights (B, N)
    -> (B, 3, 4). One Adam (betas 0.9 / 0.999, eps 1e-8 outside the square
    root) over the (B, 6) and (B, 3) parameters, on the sum of the pairs'
    losses: Adam is elementwise, so each pair takes the steps it would take
    alone. Update t (from 0) uses FINETUNE_LR * 0.999^t, as optax's
    `scale_by_adam` followed by `exponential_decay(0.1, 1, 0.999)`.
    """
    xyz_src, xyz_ref, weights = xyz_src.detach(), xyz_ref.detach(), weights.detach()
    rot6d = torch.cat([pose[..., :3, 0], pose[..., :3, 1]], dim=-1).detach().clone()
    trans = pose[..., :3, 3].detach().clone()
    rot6d.requires_grad_(True)
    trans.requires_grad_(True)
    opt = torch.optim.Adam([rot6d, trans], lr=FINETUNE_LR, betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for t in range(max_iter):
            opt.param_groups[0]["lr"] = FINETUNE_LR * 0.999 ** t
            opt.zero_grad(set_to_none=True)
            moved = xyz_src @ _rot6d_to_matrix(rot6d).transpose(-1, -2) + trans[..., None, :]
            _smooth_l1(moved, xyz_ref, weights, quantization_size).sum().backward()
            opt.step()
    with torch.no_grad():
        return torch.cat([_rot6d_to_matrix(rot6d), trans[..., None]], dim=-1)


@torch.no_grad()
def average_poses(transforms: torch.Tensor) -> torch.Tensor:
    """Chordal L2 mean of SE(3) estimates: the mean rotation projected back
    onto SO(3) by SVD, the mean translation. (k, B, 3, 4) -> (B, 3, 4)."""
    r_mean = transforms[..., :3, :3].mean(dim=0)
    t_mean = transforms[..., :3, 3].mean(dim=0)
    u, _, vt = torch.linalg.svd(r_mean)
    flip = torch.ones_like(t_mean)
    flip[..., 2] = torch.sign(torch.linalg.det(u @ vt))
    return torch.cat([(u * flip[..., None, :]) @ vt, t_mean[..., None]], dim=-1)


@torch.no_grad()
def pose_optimization(cfgs: RunConfig, arrays: Dict[str, np.ndarray], out, pose_in,
                      transforms: Optional[torch.Tensor] = None,
                      ransac_picks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The optional refiners of cfgs.eval on the eval step's final poses
    pose_in (B, 3, 4); returns pose_in where all are off.

    `out` is the eval step's AlignOutput, `transforms` its poses (iters, B,
    3, 4), `arrays` the host batch, whose clouds ICP reads. RANSAC's
    samples (H, 3), the same for every pair as JAX draws them from one key,
    are `ransac_picks` if given, else drawn from a generator seeded 0 on the
    poses' device, as JAX draws from PRNGKey(0) for every batch.
    """
    ev = cfgs.eval
    pose = pose_in
    device = pose.device
    corres_dist = cfgs.voxel_size * 2

    if ev.pose_average_last > 1 and transforms is not None:
        pose = average_poses(transforms[-min(ev.pose_average_last, transforms.shape[0]):])

    if ev.use_ransac:
        idx = out.pred_idx[-1]                                       # (B, N)
        rows = torch.arange(idx.shape[-1], device=device).expand_as(idx)
        corres = torch.stack([rows, idx], dim=-1)
        if ransac_picks is None:
            ransac_picks = torch.randint(0, idx.shape[-1], (RANSAC_HYPOTHESES, 3),
                                         generator=torch.Generator(device).manual_seed(0),
                                         device=device)
        pose = torch.stack([ransac_correspondence(s, r, c, corres_dist, picks=ransac_picks)[0]
                            for s, r, c in zip(out.pt_src, out.pt_ref, corres)])

    if ev.use_finetune:
        weights = torch.sigmoid(out.inlier_logits[-1])                # (B, N)
        matched = gather_points(out.pt_ref, out.pred_idx[-1])
        pose = finetune_pose(out.pt_src, matched, pose, weights, corres_dist)

    if ev.use_icp:
        src, ref = (torch.as_tensor(np.ascontiguousarray(arrays[k][..., :3]), device=device)
                    for k in ("points_src", "points_ref"))
        pose = icp(src, ref, corres_dist, init=pose, num_iter=ICP_ITERS)
    return pose


# --------------------------------------------------------------------------
# Align inference and evaluation
# --------------------------------------------------------------------------

def print_stats(stats: np.ndarray) -> None:
    succ_rate, rte, rre, avg_time, _ = stats.mean(axis=0)
    _logger.info("All result mean:")
    _logger.info("Time: %.3f, RTE all: %.3f, RRE all: %.3f, Success: %.3f %%",
                 avg_time, rte, rre, succ_rate * 100)
    sel = stats[stats[:, 0] > 0]
    if len(sel) > 0:
        succ_rate, rte, rre, avg_time, _ = sel.mean(axis=0)
        _logger.info("Success result mean:")
        _logger.info("Time: %.3f, RTE all: %.3f, RRE all: %.3f", avg_time, rte, rre)


def inference_align(loader, eval_step, cfgs: RunConfig, stats_path: Optional[str] = None,
                    ransac_picks: Optional[torch.Tensor] = None
                    ) -> Tuple[np.ndarray, Dict[str, list]]:
    """The timed inference sweep over `loader`'s host batch dicts.

    Returns (pred_transforms (B_total, iters + 1, 3, 4), endpoints lists);
    the last pose of each pair is the refined one. Each batch's arrays move
    to `eval_step.device` ahead of the step (`device_prefetch`), point
    payloads in cfgs.eval.transfer_dtype. stats.npz rows: success, RTE, RRE,
    the batch's seconds on the clock, the pair's "seq" meta.
    """
    device = eval_step.device
    transfer_dtype = np.dtype(cfgs.eval.transfer_dtype)

    def transfer(batch):
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        if transfer_dtype != np.float32:
            arrays = {k: v.astype(transfer_dtype) if k in ("points_src", "points_ref") else v
                      for k, v in arrays.items()}
        return batch, {k: to_device(v, device) for k, v in arrays.items()}

    total_time = 0.0
    total_rotation, pred_all, stats_rows = [], [], []
    endpoints_out: Dict[str, list] = defaultdict(list)
    warmed = False
    for batch, dev_arrays in device_prefetch(loader, transfer=transfer, device=device):
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        gt = arrays["transform_gt"]
        rot_trace = gt[:, 0, 0] + gt[:, 1, 1] + gt[:, 2, 2]
        total_rotation.append(np.degrees(np.arccos(
            np.clip(0.5 * (rot_trace - 1), -1 + _EPS, 1 - _EPS))))

        if not warmed:
            eval_step(dev_arrays)
            _fence(device)
            warmed = True

        t0 = time.perf_counter()
        transforms, out = eval_step(dev_arrays)
        _fence(device)
        dt = time.perf_counter() - t0
        total_time += dt

        pose = pose_optimization(cfgs, arrays, out, transforms[-1], transforms=transforms,
                                 ransac_picks=ransac_picks)
        stacked = torch.cat([transforms, pose[None]], dim=0).cpu().numpy()
        pred_all.append(np.transpose(stacked, (1, 0, 2, 3)))

        pose_np = stacked[-1]
        metas = batch.get("meta", [{}] * len(gt))
        for i in range(len(gt)):
            stats_rows.append(np.concatenate([
                rte_rre(pose_np[i], gt[i], cfgs.eval.rte_thresh, cfgs.eval.rre_thresh),
                [dt, float(metas[i].get("seq", 0))]]))
        endpoints_out["scores_src"].append(out.score_src.cpu().numpy())
        endpoints_out["scores_ref"].append(out.score_ref.cpu().numpy())

    stats = np.stack(stats_rows)                      # (B_total, 5)
    _logger.info("Total inference time: %.3fs", total_time)
    rot = np.concatenate(total_rotation)
    _logger.info("Rotation range in test data: %.3f(avg), %.3f(max)", rot.mean(), rot.max())
    if stats_path is not None:
        np.savez(stats_path, stats=stats[None], names=["Ours"])
        _logger.info("Saved stats to %s", stats_path)
    print_stats(stats)
    return np.concatenate(pred_all, axis=0), dict(endpoints_out)


def evaluate_align(pred_transforms: np.ndarray, loader, cfgs: RunConfig, device="cuda"
                   ) -> Tuple[List[Dict[str, np.ndarray]], Dict[str, float]]:
    """The metric sweep of each registration iteration over `loader`'s
    batches (chamfer over the first 1024 points), on `device`.
    pred_transforms (B_total, iters, 3, 4) or (B_total, 3, 4). Returns the
    per-iteration metrics and the last iteration's summary."""
    if pred_transforms.ndim == 3:
        pred_transforms = pred_transforms[:, None]
    n_iter = pred_transforms.shape[1]
    per_iter = [defaultdict(list) for _ in range(n_iter)]

    done = 0
    for batch in loader:
        src = batch["points_src"][:, :1024]
        ref = batch["points_ref"][:, :1024]
        bs = len(src)
        for i in range(n_iter):
            m = compute_metrics(batch["transform_gt"], pred_transforms[done:done + bs, i],
                                src, ref, cfgs.eval.rte_thresh, cfgs.eval.rre_thresh,
                                max_points=1024, mask_src=batch.get("mask_src"),
                                mask_ref=batch.get("mask_ref"), device=device)
            for k, v in m.items():
                per_iter[i][k].append(v)
        done += bs

    summary: Dict[str, float] = {}
    metrics_list = []
    for i in range(n_iter):
        merged = {k: np.concatenate(v) for k, v in per_iter[i].items()}
        metrics_list.append(merged)
        summary = summarize_metrics(merged)
        print_metrics(_logger, summary, title=f"Evaluation result (iter {i})")
    return metrics_list, summary


def save_eval_align(pred_transforms: np.ndarray, endpoints: Dict,
                    metrics: List[Dict[str, np.ndarray]],
                    summary: Dict[str, float], save_path: str) -> None:
    """The eval artifacts: pred_transforms.npy, the endpoints (.npy for an
    array, .pickle otherwise), metrics_iter_{i}.csv and metrics.xlsx (sheet
    Iter_{i}) with one row per pair (mse columns as rmse), and
    summary_metrics.json."""
    os.makedirs(save_path, exist_ok=True)
    np.save(os.path.join(save_path, "pred_transforms.npy"), pred_transforms)
    for k, v in endpoints.items():
        if isinstance(v, np.ndarray):
            np.save(os.path.join(save_path, f"{k}.npy"), v)
        else:
            with open(os.path.join(save_path, f"{k}.pickle"), "wb") as fid:
                pickle.dump(v, fid)

    sheets = {}
    for i, m in enumerate(metrics):
        m = dict(m)
        m["r_rmse"] = np.sqrt(m.pop("r_mse"))
        m["t_rmse"] = np.sqrt(m.pop("t_mse"))
        keys = list(m)
        rows = np.stack([np.asarray(m[k], dtype=np.float64) for k in keys], 1)
        sheets[f"Iter_{i + 1}"] = (keys, rows)
        with open(os.path.join(save_path, f"metrics_iter_{i + 1}.csv"), "w") as f:
            f.write(",".join(keys) + "\n")
            for row in rows:
                f.write(",".join(f"{x:.8g}" for x in row) + "\n")
    write_xlsx(os.path.join(save_path, "metrics.xlsx"), sheets)

    with open(os.path.join(save_path, "summary_metrics.json"), "w") as f:
        json.dump({k: float(v) for k, v in summary.items()}, f, indent=2)
    _logger.info("Saved evaluation results to %s", save_path)


# --------------------------------------------------------------------------
# Feat and label inference
# --------------------------------------------------------------------------

def _save_txt(path: str, arr: np.ndarray) -> None:
    np.savetxt(path, arr, fmt="%.6f")


def _timed(fwd_step, arrays, warm: bool):
    """fwd_step(arrays) and its seconds up to a fence; an untimed call first
    when `warm`."""
    if warm:
        _fence(fwd_step(arrays).xyz_src.device)
    t0 = time.perf_counter()
    out = fwd_step(arrays)
    _fence(out.xyz_src.device)
    return out, time.perf_counter() - t0


def inference_feat(loader, fwd_step, save_path: str, dump_every: int = 10) -> None:
    """The scored-keypoint dump sweep: every `dump_every`-th pair's first
    cloud pair as {count:06d}_{src,ref}_pt.txt (keypoints, the source moved
    by the ground truth, and their scores) and _raw.txt (the input cloud)."""
    os.makedirs(save_path, exist_ok=True)
    total_time = 0.0
    count = 0
    for batch in loader:
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        out, dt = _timed(fwd_step, arrays, count == 0)
        total_time += dt

        if count % dump_every == 0:
            gt = arrays["transform_gt"]
            xyz_src = se3_np.transform(gt[0], out.xyz_src[0].cpu().numpy())
            xyz_ref = out.xyz_ref[0].cpu().numpy()
            raw_src = se3_np.transform(gt[0], arrays["points_src"][0, :, :3])
            raw_ref = arrays["points_ref"][0, :, :3]
            for name, xyz, score, raw in (("src", xyz_src, out.score_src, raw_src),
                                          ("ref", xyz_ref, out.score_ref, raw_ref)):
                pt = np.concatenate([xyz, score[0].cpu().numpy()[:, None]], 1)
                _save_txt(os.path.join(save_path, f"{count:06d}_{name}_pt.txt"), pt)
                _save_txt(os.path.join(save_path, f"{count:06d}_{name}_raw.txt"), raw)
        count += len(arrays["points_src"])
    _logger.info("Total inference time: %.3fs", total_time)


def inference_label(loader, fwd_step, save_path: str, dump_every: int = 10
                    ) -> Tuple[float, list, float]:
    """The semantic inference sweep: (mean IoU, per-class IoU, accuracy) over
    both clouds of every pair; every `dump_every`-th pair's first cloud pair
    dumped as {count:06d}_{src,ref}.txt (points and predicted label 1..19)."""
    os.makedirs(save_path, exist_ok=True)
    metric = SemanticMetric()
    total_time = 0.0
    count = 0
    for batch in loader:
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        out, dt = _timed(fwd_step, arrays, count == 0)
        total_time += dt

        for logits, labels in ((out.logits_src, arrays["labels_src"]),
                               (out.logits_ref, arrays["labels_ref"])):
            metric.update(confusion_matrix(logits, torch.as_tensor(labels, device=logits.device)))

        if count % dump_every == 0:
            for name, xyz, logits in (("src", out.xyz_src, out.logits_src),
                                      ("ref", out.xyz_ref, out.logits_ref)):
                pred = np.argmax(logits[0].cpu().numpy(), axis=-1) + 1
                pt = np.concatenate([xyz[0].cpu().numpy(), pred[:, None].astype(np.float32)], 1)
                _save_txt(os.path.join(save_path, f"{count:06d}_{name}.txt"), pt)
        count += len(arrays["points_src"])

    _logger.info("Total inference time: %.3fs", total_time)
    mean_iou, iou_list, mean_acc = metric.compute()
    _logger.info("Validation accuracy: %.3f", mean_acc)
    _logger.info("Mean IoU: %.1f", mean_iou * 100)
    _logger.info("IoU: %s", "|".join(
        f"{name}:{100 * v:5.2f}" for name, v in zip(LABEL_NAMES, iou_list)))
    return mean_iou, iou_list, mean_acc
