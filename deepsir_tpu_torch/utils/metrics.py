"""Registration metrics (deepsir_tpu/utils/metrics.py).

The RTE/RRE success test, the DCP-convention Euler errors, the isotropic
rotation and translation errors and the modified chamfer distance. The
pose errors and the chamfer term run in torch on the given device; the
Euler conversion runs on the host through scipy, as in the JAX package.
Inputs are cast to float32 first, as `jnp.asarray` casts them there.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from deepsir_tpu_torch.math import se3, so3
from deepsir_tpu_torch.ops.distance import min_square_distance

_EPS = 1e-16


def rte_rre(t_pred: np.ndarray, t_gt: np.ndarray,
            rte_thresh: float, rre_thresh: float) -> np.ndarray:
    """[success, RTE, RRE (deg)] of one pose against the truth, (3/4, 4) each."""
    if t_pred is None:
        return np.array([0.0, np.inf, np.inf])
    rte = np.linalg.norm(t_pred[:3, 3] - t_gt[:3, 3])
    cos = (np.trace(t_pred[:3, :3].T @ t_gt[:3, :3]) - 1) / 2
    rre = np.arccos(np.clip(cos, -1 + _EPS, 1 - _EPS)) * 180 / np.pi
    return np.array([float(rte < rte_thresh and rre < rre_thresh), rte, rre])


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def compute_metrics(transform_gt, pred_transforms, points_src, points_ref,
                    rte_thresh: float, rre_thresh: float, max_points: int = 2048,
                    mask_src=None, mask_ref=None, device="cuda") -> Dict[str, np.ndarray]:
    """Per-pair metrics (host arrays in, host arrays out).

    transform_gt, pred_transforms (B, 3, 4); points_src, points_ref (B, N, >=3),
    of which the chamfer term reads the first `max_points`. mask_src and
    mask_ref (B, N) mark the real points of clouds padded by tile
    duplication: a duplicate never changes a minimum, so the masked means
    give the natural-size statistics. (The JAX function's `points_raw`,
    which no caller passes, is left out: the chamfer's raw cloud is the
    moved source and the reference.)
    """
    gt = np.asarray(transform_gt, dtype=np.float32)
    pred = np.asarray(pred_transforms, dtype=np.float32)
    r_gt = so3.dcm2euler(gt[:, :3, :3], seq="xyz")
    r_pred = so3.dcm2euler(pred[:, :3, :3], seq="xyz")
    t_gt, t_pred = gt[:, :3, 3], pred[:, :3, 3]
    r_mse = np.mean((r_gt - r_pred) ** 2, axis=1)
    r_mae = np.mean(np.abs(r_gt - r_pred), axis=1)
    t_mse = np.mean((t_gt - t_pred) ** 2, axis=1)
    t_mae = np.mean(np.abs(t_gt - t_pred), axis=1)

    with torch.no_grad():
        g_gt, g_pr = _f32(gt, device), _f32(pred, device)
        src = _f32(np.asarray(points_src)[:, :max_points, :3], device)
        ref = _f32(np.asarray(points_ref)[:, :max_points, :3], device)
        err_r_deg, err_t = (e.cpu().numpy() for e in se3.pose_error(g_gt, g_pr))
        raw = torch.cat([se3.transform(g_gt, src), ref], dim=1)
        src_clean = se3.transform(se3.concatenate(g_pr, se3.inverse(g_gt)), raw)
        dist_src = min_square_distance(se3.transform(g_pr, src), raw)
        dist_ref = min_square_distance(ref, src_clean)
        if mask_src is None:
            chamfer = dist_src.mean(dim=1) + dist_ref.mean(dim=1)
        else:
            m_src = _f32(np.asarray(mask_src)[:, :max_points], device)
            m_ref = _f32(np.asarray(mask_ref)[:, :max_points], device)
            chamfer = ((dist_src * m_src).sum(dim=1) / m_src.sum(dim=1)
                       + (dist_ref * m_ref).sum(dim=1) / m_ref.sum(dim=1))
    success = (err_t < rte_thresh) * (err_r_deg < rre_thresh)
    return {"r_mse": r_mse, "r_mae": r_mae, "t_mse": t_mse, "t_mae": t_mae,
            "err_r_deg": err_r_deg, "err_t": err_t,
            "succ": success.astype(np.float64), "chamfer_dist": chamfer.cpu().numpy()}


def summarize_metrics(metrics: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Means over the pairs; each mse becomes an rmse, each err_* gets its
    mean and its rmse."""
    out: Dict[str, float] = {}
    for k, v in metrics.items():
        if k.endswith("mse"):
            out[k[:-3] + "rmse"] = float(np.sqrt(np.mean(v)))
        elif k.startswith("err"):
            out[k + "_mean"] = float(np.mean(v))
            out[k + "_rmse"] = float(np.sqrt(np.mean(v ** 2)))
        else:
            out[k] = float(np.mean(v))
    return out


def print_metrics(logger, summary: Dict[str, float], title: str = "Metrics") -> None:
    """The JAX package's metric report, line for line (without its
    `losses_by_iteration` line, which no caller asks for)."""
    logger.info("-" * (len(title) + 3))
    logger.info("%s:", title)
    logger.info("DCP metrics: %.4f (rot-rmse) | %.4f (rot-mae) | "
                "%.4g (trans-rmse) | %.4g (trans-mae)",
                summary["r_rmse"], summary["r_mae"],
                summary["t_rmse"], summary["t_mae"])
    logger.info("Rotation error: %.4f deg (mean) | %.4f deg (rmse)",
                summary["err_r_deg_mean"], summary["err_r_deg_rmse"])
    logger.info("Translation error: %.4g (mean) | %.4g (rmse)",
                summary["err_t_mean"], summary["err_t_rmse"])
    logger.info("Chamfer error: %.7f (mean-sq)", summary["chamfer_dist"])
    logger.info("Success rate: %.3f", summary["succ"])
