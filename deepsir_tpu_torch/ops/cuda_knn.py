"""The pyramid's KNN kernels and their plain PyTorch versions.

K1, `csrc/knn_topk.cu`, replaces deepsir_tpu/ops/pallas_knn.py::knn_topk_single:
exact k-NN top-k over the whole ref array.
K4, `csrc/knn_windowed.cu`, replaces
deepsir_tpu/ops/pallas_knn.py::knn_topk_windowed_single: the same search with
each 128-row query tile restricted to its curve-rank window (ops/window.py),
for curve-sorted clouds.
Kernels and plain versions compute squared distances by direct subtraction,
sum_d (q_d - r_d)^2 in coordinate order with every operation rounded on its
own, so they agree bit for bit; neighbours come back ascending with ties to
the lowest ref index. Unlike the TPU kernels, distances are exact (not
quantised) and selection is exact at every size.
"""
from __future__ import annotations

import ctypes

import torch

from deepsir_tpu_torch.ops import _build
from deepsir_tpu_torch.ops.window import TQ, start_rows

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
        dist, idx = torch.sort(_sq_dist(query[:, s:s + chunk, None], ref[:, None]),
                               dim=-1, stable=True)
        idx_parts.append(idx[..., :k])
        dist_parts.append(dist[..., :k])
    return torch.cat(idx_parts, dim=1), torch.cat(dist_parts, dim=1)


def _sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """sum_d (q_d - r_d)^2 over the last axis, in coordinate order, with q
    and r broadcast against each other."""
    acc = None
    for c in range(q.shape[-1]):
        diff = q[..., c] - r[..., c]
        sq = diff * diff
        acc = sq if acc is None else acc + sq
    return acc


def knn_topk_windowed_plain(query: torch.Tensor, ref: torch.Tensor, k: int,
                            halo: int):
    """(B, N, D) x (B, M, D) -> (idx (B, N, k) int64, sq_dist (B, N, k) f32),
    each TQ-row query tile searching only its window of ops/window.py.

    Per tile: the window's refs gathered, distances as `knn_topk_plain`, refs
    past M at +inf, a stable sort, the first k.
    """
    b, n, d = query.shape
    m = ref.shape[1]
    rows, starts = start_rows(n, m, halo)
    ntiles = len(starts)
    col = torch.tensor(starts, device=query.device)[:, None] + \
        torch.arange(rows, device=query.device)                   # (T, W)
    q = torch.nn.functional.pad(query, (0, 0, 0, ntiles * TQ - n))
    q = q.reshape(b, ntiles, TQ, 1, d)
    chunk = max(1, _CHUNK_ELEMS // max(1, b * TQ * rows))
    idx_parts, dist_parts = [], []
    for s in range(0, ntiles, chunk):
        c = col[s:s + chunk]
        win = ref[:, c.clamp(max=m - 1)]                           # (B, t, W, D)
        dist = _sq_dist(q[:, s:s + chunk], win[:, :, None])        # (B, t, TQ, W)
        dist = dist.masked_fill((c >= m)[None, :, None, :], float("inf"))
        dist, order = torch.sort(dist, dim=-1, stable=True)
        idx_parts.append(torch.gather(c[None, :, None, :].expand(order.shape), -1,
                                      order[..., :k]))
        dist_parts.append(dist[..., :k])
    idx = torch.cat(idx_parts, dim=1).reshape(b, ntiles * TQ, k)[:, :n]
    dist = torch.cat(dist_parts, dim=1).reshape(b, ntiles * TQ, k)[:, :n]
    return idx, dist


def _lib():
    lib = _build.load("knn_topk")
    fn = lib.knn_topk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_args(query: torch.Tensor, ref: torch.Tensor) -> None:
    """Shapes the searches take; raises ValueError otherwise."""
    if query.dim() != 3 or ref.dim() != 3 or query.shape[0] != ref.shape[0] \
            or query.shape[2] != ref.shape[2] or query.shape[1] < 1 \
            or not (1 <= query.shape[2] <= MAX_DIM):
        raise ValueError(f"shapes {tuple(query.shape)} x {tuple(ref.shape)}: "
                         f"need N >= 1 and 1 <= D <= {MAX_DIM}")


def _check_k(k: int, k_max: int, what: str) -> None:
    if not 1 <= k <= min(k_max, MAX_K):
        raise ValueError(f"{what} needs 1 <= k <= {min(k_max, MAX_K)}; got k={k}")


def _check_cuda(query: torch.Tensor, ref: torch.Tensor) -> None:
    """What the kernels take besides shapes; raises otherwise."""
    if query.device.type != "cuda" or ref.device != query.device:
        raise ValueError(f"devices {query.device}, {ref.device}")
    if query.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"dtypes {query.dtype}, {ref.dtype}: float32 only")
    if not (query.is_contiguous() and ref.is_contiguous()):
        raise ValueError("query and ref must be contiguous")


def knn_topk(query: torch.Tensor, ref: torch.Tensor, k: int):
    """(B, N, D) x (B, M, D) -> (idx (B, N, k) int64, sq_dist (B, N, k) f32).

    CUDA tensors launch the kernel; CPU tensors take `knn_topk_plain`.
    Requires 1 <= k <= min(M, 32) and 1 <= D <= 8.
    """
    _check_args(query, ref)
    _check_k(k, ref.shape[1], "knn_topk")
    if query.device.type == "cpu" and ref.device.type == "cpu":
        return knn_topk_plain(query, ref, k)
    _check_cuda(query, ref)
    b, n, d = query.shape
    m = ref.shape[1]
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


_STARTS = {}        # (n, m, halo, device) -> the int32 start table on the card


def _lib_windowed():
    lib = _build.load("knn_windowed")
    fn = lib.knn_windowed_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def knn_topk_windowed(query: torch.Tensor, ref: torch.Tensor, k: int, halo: int):
    """(B, N, D) x (B, M, D) -> (idx (B, N, k) int64, sq_dist (B, N, k) f32),
    each TQ-row query tile searching only its window of ops/window.py.

    Only meaningful for curve-sorted clouds. CUDA tensors launch the kernel;
    CPU tensors take `knn_topk_windowed_plain`. Requires 1 <= D <= 8 and
    1 <= k <= 32 refs in every window.
    """
    _check_args(query, ref)
    n, m = query.shape[1], ref.shape[1]
    rows, starts = start_rows(n, m, halo)
    _check_k(k, min(min(m, s + rows) - s for s in starts), "knn_topk_windowed")
    if query.device.type == "cpu" and ref.device.type == "cpu":
        return knn_topk_windowed_plain(query, ref, k, halo)
    _check_cuda(query, ref)
    b, _, d = query.shape
    key = (n, m, halo, query.device)
    table = _STARTS.get(key)
    if table is None:
        table = torch.tensor(starts, dtype=torch.int32, device=query.device)
        _STARTS[key] = table
    idx = torch.empty((b, n, k), dtype=torch.int64, device=query.device)
    dist = torch.empty((b, n, k), dtype=torch.float32, device=query.device)
    fn = _lib_windowed()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(query.data_ptr(), ref.data_ptr(), table.data_ptr(), rows,
                    idx.data_ptr(), dist.data_ptr(), b, n, m, d, k, stream)
    _build.check(status, "knn_windowed_launch")
    knn_topk_windowed.launches += 1
    return idx, dist


knn_topk_windowed.launches = 0
