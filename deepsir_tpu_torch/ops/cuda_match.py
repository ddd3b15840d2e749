"""The correspondence search's kernels and their plain PyTorch versions.

K2, `csrc/match_argmin.cu`, replaces
deepsir_tpu/ops/pallas_match.py::match_argmin_single: for every src row the
ref row minimising |r|^2 - 2 s.r, ties to the lowest index.
K3, `csrc/match_bidir.cu`, replaces
deepsir_tpu/ops/pallas_match.py::match_argmin_bidirectional: K2's result and,
in the same pass, for every ref row the src row minimising the full distance
(|r|^2 - 2 s.r) + |s|^2, ties to the lowest index.
Both kernels share the tensor-core core `csrc/match_core.cuh`, in two forms:
fp32-grade products (three TF32 products per step, 3xTF32) by default, and
with `low_precision` bf16 operands with fp32 accumulation, as the TPU
kernels' `low_precision`. The plain versions of the bf16 form round src and
ref to bf16 and run the fp32 search, with the norms from the fp32 inputs.
Kernel and plain version sum the dot products in different orders, so they
may pick different rows only where two distances are within float rounding
of each other.
"""
from __future__ import annotations

import ctypes

import torch

from deepsir_tpu_torch.ops import _build

MAX_CHANNELS = 128
_CHUNK_ELEMS = 1 << 24          # distance-tile budget of the plain version


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back."""
    return x.to(torch.bfloat16).to(x.dtype)


def match_argmin_plain(src: torch.Tensor, ref: torch.Tensor,
                       low_precision: bool = False) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N) int64 nearest ref row under squared L2.

    Chunked `ref_sq - 2 src @ ref^T` then `argmin`, which returns the first
    minimum. `low_precision`: src and ref rounded to bf16 for the products,
    ref_sq from the fp32 inputs (pallas_match.py:231-238).
    """
    b, n, _ = src.shape
    m = ref.shape[1]
    ref_sq = torch.sum(ref * ref, dim=-1)                      # (B, M)
    if low_precision:
        src, ref = _bf16(src), _bf16(ref)
    ref_t = ref.transpose(1, 2)
    chunk = max(1, _CHUNK_ELEMS // max(1, b * m))
    parts = []
    for s in range(0, n, chunk):
        d = ref_sq[:, None, :] - 2.0 * torch.bmm(src[:, s:s + chunk], ref_t)
        parts.append(torch.argmin(d, dim=-1))
    return torch.cat(parts, dim=1)


def match_argmin_bidirectional_plain(src: torch.Tensor, ref: torch.Tensor,
                                     low_precision: bool = False):
    """(B, N, C) x (B, M, C) -> (idx (B, N), ridx (B, M)) int64.

    Chunked over src rows as `match_argmin_plain`; each chunk's column
    minima of `ref_sq - 2 src @ ref^T + src_sq` replace the running ones only
    where strictly smaller, so ties go to the lowest src row.
    `low_precision`: src and ref rounded to bf16 for the products, the norms
    from the fp32 inputs (pallas_match.py:167-175).
    """
    b, n, _ = src.shape
    m = ref.shape[1]
    ref_sq = torch.sum(ref * ref, dim=-1)                      # (B, M)
    src_sq = torch.sum(src * src, dim=-1)                      # (B, N)
    if low_precision:
        src, ref = _bf16(src), _bf16(ref)
    ref_t = ref.transpose(1, 2)
    chunk = max(1, _CHUNK_ELEMS // max(1, b * m))
    parts = []
    col_d = torch.full((b, m), float("inf"), dtype=src.dtype, device=src.device)
    col_i = torch.zeros((b, m), dtype=torch.int64, device=src.device)
    for s in range(0, n, chunk):
        d = ref_sq[:, None, :] - 2.0 * torch.bmm(src[:, s:s + chunk], ref_t)
        parts.append(torch.argmin(d, dim=-1))
        dc = d + src_sq[:, s:s + chunk, None]
        arg = torch.argmin(dc, dim=1)                          # (B, M)
        best = torch.gather(dc, 1, arg[:, None, :])[:, 0]
        take = best < col_d
        col_d = torch.where(take, best, col_d)
        col_i = torch.where(take, arg + s, col_i)
    return torch.cat(parts, dim=1), col_i


def _check_pair(src: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    """Shapes and sizes every search takes; raises ValueError otherwise."""
    if src.dim() != 3 or ref.dim() != 3 or src.shape[0] != ref.shape[0] \
            or src.shape[2] != ref.shape[2]:
        raise ValueError(f"shapes {tuple(src.shape)} x {tuple(ref.shape)}")
    n, c = src.shape[1], src.shape[2]
    m = ref.shape[1]
    if not (1 <= c <= MAX_CHANNELS) or n < 1 or m < 1:
        raise ValueError(f"{what} needs 1 <= C <= {MAX_CHANNELS} and "
                         f"non-empty clouds; got N={n}, M={m}, C={c}")


def _check_cuda(src: torch.Tensor, ref: torch.Tensor) -> None:
    """What the kernels take besides shapes; raises otherwise."""
    if src.device.type != "cuda" or ref.device != src.device:
        raise ValueError(f"devices {src.device}, {ref.device}")
    if src.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"dtypes {src.dtype}, {ref.dtype}: float32 only")
    if not (src.is_contiguous() and ref.is_contiguous()):
        raise ValueError("src and ref must be contiguous")


def _lib():
    lib = _build.load("match_argmin")
    fn = lib.match_argmin_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def match_argmin(src: torch.Tensor, ref: torch.Tensor,
                 low_precision: bool = False) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N) int64 nearest ref row under squared L2.

    CUDA tensors launch the kernel; CPU tensors take `match_argmin_plain`.
    Requires C <= 128. `low_precision` takes bf16 operands, fp32-grade
    products otherwise. One call counts one launch in `.launches`, and also
    in `.launches_lp` when it takes bf16 operands, though the kernel's
    launcher issues three device operations.
    """
    _check_pair(src, ref, "match_argmin")
    if src.device.type == "cpu" and ref.device.type == "cpu":
        return match_argmin_plain(src, ref, low_precision)
    _check_cuda(src, ref)
    b, n, c = src.shape
    m = ref.shape[1]
    ref_sq = torch.sum(ref * ref, dim=-1)
    out = torch.empty((b, n), dtype=torch.int64, device=src.device)
    fn = _lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(src.data_ptr(), ref.data_ptr(), ref_sq.data_ptr(),
                    out.data_ptr(), b, n, m, c, int(low_precision), stream)
    _build.check(status, "match_argmin_launch")
    match_argmin.launches += 1
    match_argmin.launches_lp += int(low_precision)
    return out


match_argmin.launches = match_argmin.launches_lp = 0


def _lib_bidir():
    lib = _build.load("match_bidir")
    fn = lib.match_bidir_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def match_argmin_bidirectional(src: torch.Tensor, ref: torch.Tensor,
                               low_precision: bool = False):
    """(B, N, C) x (B, M, C) -> (idx (B, N), ridx (B, M)) int64: the nearest
    ref row of every src row and the nearest src row of every ref row.

    CUDA tensors launch the kernel; CPU tensors take
    `match_argmin_bidirectional_plain`. Requires C <= 128. `low_precision`
    takes bf16 operands, fp32-grade products otherwise. One call counts one
    launch in `.launches`, and also in `.launches_lp` when it takes bf16
    operands, though the kernel's launcher issues four device operations.
    """
    _check_pair(src, ref, "match_argmin_bidirectional")
    if src.device.type == "cpu" and ref.device.type == "cpu":
        return match_argmin_bidirectional_plain(src, ref, low_precision)
    _check_cuda(src, ref)
    b, n, c = src.shape
    m = ref.shape[1]
    src_sq = torch.sum(src * src, dim=-1)
    ref_sq = torch.sum(ref * ref, dim=-1)
    idx = torch.empty((b, n), dtype=torch.int64, device=src.device)
    ridx = torch.empty((b, m), dtype=torch.int64, device=src.device)
    fn = _lib_bidir()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(src.data_ptr(), ref.data_ptr(), src_sq.data_ptr(),
                    ref_sq.data_ptr(), idx.data_ptr(), ridx.data_ptr(),
                    b, n, m, c, int(low_precision), stream)
    _build.check(status, "match_bidir_launch")
    match_argmin_bidirectional.launches += 1
    match_argmin_bidirectional.launches_lp += int(low_precision)
    return idx, ridx


match_argmin_bidirectional.launches = match_argmin_bidirectional.launches_lp = 0
