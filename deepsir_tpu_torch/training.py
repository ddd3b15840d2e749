"""Host batch -> device batch with both pyramids built on the device
(deepsir_tpu/training.py::device_batch)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from deepsir_tpu_torch.config import ModelConfig, check_supported
from deepsir_tpu_torch.models.network import PairBatch
from deepsir_tpu_torch.ops.pyramid import build_cloud_pyramid

_KEYS = ("points_src", "points_ref", "transform_gt")
_MASKS = ("mask_src", "mask_ref")


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
    (B, 3, 4) and optionally the validity masks `mask_src`, `mask_ref`
    (B, N); labels and match lists are not ported. Under
    `pyramid_order="morton"` the caller passes curve-sorted clouds
    (ops/morton.py::sort_clouds); this function does not sort.
    """
    check_supported(cfg)
    extra = sorted(set(arrays) - set(_KEYS) - set(_MASKS))
    if extra:
        raise NotImplementedError(f"device_batch arrays {extra}")
    src, ref = (_to_device(arrays[k], device) for k in ("points_src", "points_ref"))
    masks = {k: _to_device(arrays[k], device) for k in _MASKS if k in arrays}
    return PairBatch(
        points_src=src, points_ref=ref,
        pyramid_src=build_cloud_pyramid(cfg, src[..., :3]),
        pyramid_ref=build_cloud_pyramid(cfg, ref[..., :3]),
        transform_gt=_to_device(arrays["transform_gt"], device), **masks)
