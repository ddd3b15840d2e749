"""Host batch -> device batch with both pyramids built on the device
(deepsir_tpu/training.py::device_batch)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from deepsir_tpu_torch.config import ModelConfig, check_supported
from deepsir_tpu_torch.models.network import PairBatch
from deepsir_tpu_torch.ops.pyramid import build_pyramid

_KEYS = ("points_src", "points_ref", "transform_gt")


def device_batch(cfg: ModelConfig, arrays: Dict[str, np.ndarray],
                 device="cuda") -> PairBatch:
    """Copy the pair arrays to `device` and build both clouds' pyramids there.

    Accepts exactly `points_src`, `points_ref` (B, N, C) and `transform_gt`
    (B, 3, 4); masks, labels and match lists are not ported. Under
    `pyramid_order="morton"` the caller passes curve-sorted clouds
    (ops/morton.py::sort_clouds); this function does not sort.
    """
    check_supported(cfg)
    extra = sorted(set(arrays) - set(_KEYS))
    if extra:
        raise NotImplementedError(f"device_batch arrays {extra}")
    src, ref = (torch.as_tensor(np.asarray(arrays[k])).to(device=device, dtype=torch.float32)
                for k in ("points_src", "points_ref"))
    morton = cfg.pyramid_order == "morton"
    sample = "strided" if morton else "first"
    halo = cfg.knn_window_halo if morton else 0
    pyr_src, pyr_ref = (build_pyramid(x[..., :3], cfg.num_knn, cfg.sub_sampling_ratio,
                                      sample=sample, window_halo=halo)
                        for x in (src, ref))
    return PairBatch(
        points_src=src, points_ref=ref, pyramid_src=pyr_src, pyramid_ref=pyr_ref,
        transform_gt=torch.as_tensor(np.asarray(arrays["transform_gt"])).to(
            device=device, dtype=torch.float32))
