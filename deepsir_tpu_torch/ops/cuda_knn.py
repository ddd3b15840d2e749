"""K1: exact k-NN top-k, the CUDA kernel `csrc/knn_topk.cu` and its plain
PyTorch version.

Replaces deepsir_tpu/ops/pallas_knn.py::knn_topk_single. Both versions
compute squared distances by direct subtraction, sum_d (q_d - r_d)^2 in
coordinate order with every operation rounded on its own, so they agree bit
for bit; neighbours come back ascending with ties to the lowest ref index.
Unlike the TPU kernel, distances are exact (not quantised) and selection is
exact at every size.
"""
from __future__ import annotations

import ctypes

import torch

from deepsir_tpu_torch.ops import _build

MAX_K = 32
MAX_DIM = 8
_CHUNK_ELEMS = 1 << 24          # distance-tile budget of the plain version


def knn_topk_plain(query: torch.Tensor, ref: torch.Tensor, k: int):
    """(B, N, D) x (B, M, D) -> (idx (B, N, k) int64, sq_dist (B, N, k) f32).

    Chunked over query rows; a stable sort over refs keeps ties in index
    order, so the first k are the nearest with ties to the lowest index.
    """
    b, n, d = query.shape
    m = ref.shape[1]
    chunk = max(1, _CHUNK_ELEMS // max(1, b * m))
    idx_parts, dist_parts = [], []
    for s in range(0, n, chunk):
        q = query[:, s:s + chunk]
        acc = None
        for c in range(d):
            diff = q[:, :, None, c] - ref[:, None, :, c]
            sq = diff * diff
            acc = sq if acc is None else acc + sq
        dist, idx = torch.sort(acc, dim=-1, stable=True)
        idx_parts.append(idx[..., :k])
        dist_parts.append(dist[..., :k])
    return torch.cat(idx_parts, dim=1), torch.cat(dist_parts, dim=1)


def _lib():
    lib = _build.load("knn_topk")
    fn = lib.knn_topk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def knn_topk(query: torch.Tensor, ref: torch.Tensor, k: int):
    """(B, N, D) x (B, M, D) -> (idx (B, N, k) int64, sq_dist (B, N, k) f32).

    CUDA tensors launch the kernel; CPU tensors take `knn_topk_plain`.
    Requires 1 <= k <= min(M, 32) and 1 <= D <= 8.
    """
    if query.dim() != 3 or ref.dim() != 3 or query.shape[0] != ref.shape[0] \
            or query.shape[2] != ref.shape[2]:
        raise ValueError(f"shapes {tuple(query.shape)} x {tuple(ref.shape)}")
    b, n, d = query.shape
    m = ref.shape[1]
    if not (1 <= k <= min(m, MAX_K)) or not (1 <= d <= MAX_DIM):
        raise ValueError(f"knn_topk needs 1 <= k <= min(M, {MAX_K}) and "
                         f"1 <= D <= {MAX_DIM}; got k={k}, M={m}, D={d}")
    if query.device.type == "cpu" and ref.device.type == "cpu":
        return knn_topk_plain(query, ref, k)
    if query.device.type != "cuda" or ref.device != query.device:
        raise ValueError(f"devices {query.device}, {ref.device}")
    if query.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"dtypes {query.dtype}, {ref.dtype}: float32 only")
    if not (query.is_contiguous() and ref.is_contiguous()):
        raise ValueError("query and ref must be contiguous")
    idx = torch.empty((b, n, k), dtype=torch.int64, device=query.device)
    dist = torch.empty((b, n, k), dtype=torch.float32, device=query.device)
    fn = _lib()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(query.data_ptr(), ref.data_ptr(), idx.data_ptr(),
                    dist.data_ptr(), b, n, m, d, k, stream)
    _build.check(status, "knn_topk_launch")
    knn_topk.launches += 1
    return idx, dist


knn_topk.launches = 0
