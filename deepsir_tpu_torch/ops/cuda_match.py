"""K2: fused descriptor distance + argmin, the CUDA kernel
`csrc/match_argmin.cu` and its plain PyTorch version.

Replaces deepsir_tpu/ops/pallas_match.py::match_argmin_single: for every src
row the ref row minimising |r|^2 - 2 s.r, ties to the lowest index. The
kernel runs fp32 FMAs on the CUDA cores; the two versions sum the dot
products in different orders, so they may pick different rows only where
two distances are within float rounding of each other.
"""
from __future__ import annotations

import ctypes

import torch

from deepsir_tpu_torch.ops import _build

MAX_CHANNELS = 128
_CHUNK_ELEMS = 1 << 24          # distance-tile budget of the plain version


def match_argmin_plain(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N) int64 nearest ref row under squared L2.

    Chunked `ref_sq - 2 src @ ref^T` then `argmin`, which returns the first
    minimum.
    """
    b, n, _ = src.shape
    m = ref.shape[1]
    ref_sq = torch.sum(ref * ref, dim=-1)                      # (B, M)
    ref_t = ref.transpose(1, 2)
    chunk = max(1, _CHUNK_ELEMS // max(1, b * m))
    parts = []
    for s in range(0, n, chunk):
        d = ref_sq[:, None, :] - 2.0 * torch.bmm(src[:, s:s + chunk], ref_t)
        parts.append(torch.argmin(d, dim=-1))
    return torch.cat(parts, dim=1)


def _lib():
    lib = _build.load("match_argmin")
    fn = lib.match_argmin_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def match_argmin(src: torch.Tensor, ref: torch.Tensor,
                 low_precision: bool = False) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N) int64 nearest ref row under squared L2.

    CUDA tensors launch the kernel; CPU tensors take `match_argmin_plain`.
    Requires C <= 128. `low_precision` (bf16 operands) is not ported.
    """
    if src.dim() != 3 or ref.dim() != 3 or src.shape[0] != ref.shape[0] \
            or src.shape[2] != ref.shape[2]:
        raise ValueError(f"shapes {tuple(src.shape)} x {tuple(ref.shape)}")
    if low_precision:
        raise NotImplementedError("match_argmin low_precision (bf16 operands)")
    b, n, c = src.shape
    m = ref.shape[1]
    if not (1 <= c <= MAX_CHANNELS) or n < 1 or m < 1:
        raise ValueError(f"match_argmin needs 1 <= C <= {MAX_CHANNELS} and "
                         f"non-empty clouds; got N={n}, M={m}, C={c}")
    if src.device.type == "cpu" and ref.device.type == "cpu":
        return match_argmin_plain(src, ref)
    if src.device.type != "cuda" or ref.device != src.device:
        raise ValueError(f"devices {src.device}, {ref.device}")
    if src.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"dtypes {src.dtype}, {ref.dtype}: float32 only")
    if not (src.is_contiguous() and ref.is_contiguous()):
        raise ValueError("src and ref must be contiguous")
    ref_sq = torch.sum(ref * ref, dim=-1)
    out = torch.empty((b, n), dtype=torch.int64, device=src.device)
    fn = _lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(src.data_ptr(), ref.data_ptr(), ref_sq.data_ptr(),
                    out.data_ptr(), b, n, m, c, stream)
    _build.check(status, "match_argmin_launch")
    match_argmin.launches += 1
    return out


match_argmin.launches = 0
