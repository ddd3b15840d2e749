// The exact k-nearest-neighbour search shared by K1 (knn_topk.cu, whole ref
// array) and K4 (knn_windowed.cu, a curve-rank window of it per query tile):
// a warp-select core in the manner of Johnson, Douze and Jegou, "Billion-scale
// similarity search with GPUs" (2017).
//
// Layout. A block of kWarps warps owns kWarps / split query groups of kQ
// queries each; the `split` warps of a group scan disjoint 32-ref chunks of
// every ref tile (chunk c goes to warp c % split), and the lanes of a warp
// scan the 32 refs of a chunk, lane l ref l. Query coordinates live in
// registers; ref tiles of kTile refs are staged once per block in shared
// memory as 16-byte records (x, y, z, pad; two records for D <= 8) through a
// kStages-deep cp.async ring with one barrier per tile, starting from the
// tile across from the block's queries and wrapping around. `split` (1, 2,
// 4 or 8) is the largest whose blocks fit the card's resident blocks at
// once, so that small searches still fill the SMs.
//
// Selection, per query and warp. The warp queue holds the 32 smallest
// candidates inserted so far as (dist, idx), one per lane, sorted ascending
// by lane; its k-th distance, broadcast to every lane, is the threshold. A
// ref passes when its distance is <= the threshold (one compare; a vote
// skips the chunk when no lane passes for any query), and a ballot collects
// the passing lanes of a chunk (each lane's thread queue is its one
// candidate of the chunk). More than kBitonicMin candidates merge through a
// bitonic network over __shfl_xor_sync: sort them descending across lanes,
// take the lane-wise minimum with the ascending warp queue, and
// bitonic-merge; fewer are inserted one at a time at the position a ballot
// finds, the queue's tail moving up a lane by __shfl_up_sync. k = 1 keeps one
// running minimum per lane instead, reduced by a warp argmin over shuffles.
// The `split` warps of a group then merge their queues through shared memory
// with the same reversed-minimum-and-merge step, and lane t writes entry t
// of each query.
//
// Tie rule: every comparison that orders entries (the insertion position,
// every compare-exchange, the merges) is lexicographic on (dist, idx), and
// the threshold test admits equal distances, so the k smallest under that
// total order are unique and do not depend on the order in which lanes,
// warps or tiles see the refs: ties go to the lowest index. The distance is
// sum_d (q_d - r_d)^2 summed over d in order with the round-to-nearest
// intrinsics, so nvcc cannot contract it into FMAs and the result is
// bit-identical to the plain PyTorch versions
// (deepsir_tpu_torch/ops/cuda_knn.py): indices must be equal.
// tests/test_torch_knn_select.py models this selection order in numpy with
// the constants below.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <mutex>

namespace knn_select {

constexpr int kQ = 4;                         // queries per warp
constexpr int kWarps = 8;                     // warps per block
constexpr int kThreads = 32 * kWarps;         // 256
constexpr int kTile = kThreads;               // refs per shared-memory tile
constexpr int kStages = 3;                    // cp.async ring depth
constexpr int kBitonicMin = 8;                // more candidates: bitonic merge
constexpr int kDimMax = 8;
constexpr int kWindowTile = 128;              // query rows per window (window.py TQ)
static_assert(kWindowTile % (kQ * kWarps) == 0, "a block must lie in one window tile");
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// One compare-exchange step of a bitonic network across lanes: lanes `j`
// apart swap, the lower lane keeping the smaller entry when `up`.
__device__ __forceinline__ void exchange(float& d, int& i, int j, bool up, int lane) {
  const float od = __shfl_xor_sync(kAll, d, j);
  const int oi = __shfl_xor_sync(kAll, i, j);
  const bool keep_min = ((lane & j) == 0) == up;
  if (keep_min ? less(od, oi, d, i) : less(d, i, od, oi)) {
    d = od;
    i = oi;
  }
}

// 32 entries, one per lane, into descending order.
__device__ __forceinline__ void sort_descending(float& d, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) exchange(d, i, j, (lane & size) != 0, lane);
}

// A bitonic sequence across lanes into ascending order.
__device__ __forceinline__ void merge_ascending(float& d, int& i, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) exchange(d, i, j, true, lane);
}

// The 32 smallest of the ascending queue (wd, wi) and the descending
// vector (vd, vi), ascending, into (wd, wi).
__device__ __forceinline__ void merge_into(float& wd, int& wi, float vd, int vi, int lane) {
  if (less(vd, vi, wd, wi)) {
    wd = vd;
    wi = vi;
  }
  merge_ascending(wd, wi, lane);
}

// The candidates of the lanes in `mask` (distance acc, index j) into the
// warp queue (wd, wi); td is its k-th distance after. Every candidate passed
// `acc <= td` against an earlier td, so it may no longer beat the k-th entry:
// it then lands past lane k - 1 or, beating no entry, is dropped.
__device__ __forceinline__ void insert(float& wd, int& wi, float& td, unsigned mask,
                                       float acc, int j, int lane, int k) {
  if (__popc(mask) > kBitonicMin) {
    const bool mine = (mask >> lane) & 1u;
    float vd = mine ? acc : __int_as_float(0x7f800000);
    int vi = mine ? j : INT_MAX;
    sort_descending(vd, vi, lane);
    merge_into(wd, wi, vd, vi, lane);
  } else {
    do {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float cd = __shfl_sync(kAll, acc, src);
      const int ci = __shfl_sync(kAll, j, src);
      // the queue is ascending, so the entries the candidate beats are a
      // suffix; it takes the first of them and the suffix moves up a lane
      const unsigned beat = __ballot_sync(kAll, less(cd, ci, wd, wi));
      const float ud = __shfl_up_sync(kAll, wd, 1);
      const int ui = __shfl_up_sync(kAll, wi, 1);
      if (beat) {
        const int pos = __ffs(beat) - 1;
        if (lane > pos) {
          wd = ud;
          wi = ui;
        } else if (lane == pos) {
          wd = cd;
          wi = ci;
        }
      }
    } while (mask);
  }
  td = __shfl_sync(kAll, wd, k - 1);
}

__device__ __forceinline__ void cp_async4(void* smem, const float* src, bool copy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(copy ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// q (DP coordinates) against the ref of float4 records rec[0..(DP + 3) / 4):
// the direct sum in coordinate order, each operation rounded on its own.
template <int DP>
__device__ __forceinline__ float sq_dist(const float* q, const float4* rec) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const float4 v = rec[c / 4];
    const float r = (c % 4 == 0) ? v.x : (c % 4 == 1) ? v.y : (c % 4 == 2) ? v.z : v.w;
    const float diff = __fsub_rn(q[c], r);
    const float sq = __fmul_rn(diff, diff);
    acc = c == 0 ? sq : __fadd_rn(acc, sq);
  }
  return acc;
}

// win_start == nullptr: every query searches refs [0, m). Otherwise the
// queries of window tile t = row / kWindowTile search
// [win_start[t], min(m, win_start[t] + win_rows)). kArgmin: the k = 1 form.
// (at least 3 blocks per SM caps registers at 85: no instance spills, and
// the main instance still fits 4 blocks per SM)
template <bool kArgmin, int DP>
__global__ void __launch_bounds__(kThreads, 3)
knn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
           const int* __restrict__ win_start, int win_rows,
           long long* __restrict__ idx_out, float* __restrict__ dist_out,
           int n, int m, int d, int k, int split) {
  constexpr int R = (DP + 3) / 4;             // float4 records per ref
  // stage s, record c, ref r at tile[(s * R + c) * kTile + r]
  __shared__ float4 tile[kStages * R * kTile];
  __shared__ float red_d[kWarps][kQ][32];
  __shared__ int red_i[kWarps][kQ][32];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = warp / split;             // query group of this warp
  const int part = warp - group * split;      // its share of every tile's chunks
  const int q0 = blockIdx.x * (kQ * kWarps / split);
  const int qg = q0 + group * kQ;
  const float* qb = query + (size_t)b * n * d;
  const float* rb = ref + (size_t)b * m * d;
  int j_lo = 0, j_hi = m;
  if (win_start != nullptr) {
    j_lo = win_start[q0 / kWindowTile];
    j_hi = min(m, j_lo + win_rows);
  }

  // coordinates past d are zero on both sides: they add exact zeros
  float q[kQ][DP];
#pragma unroll
  for (int a = 0; a < kQ; ++a)
#pragma unroll
    for (int c = 0; c < DP; ++c)
      q[a][c] = (qg + a < n && c < d) ? qb[(size_t)(qg + a) * d + c] : 0.f;

  const float inf = __int_as_float(0x7f800000);
  float wd[kQ], td[kQ];
  int wi[kQ];
#pragma unroll
  for (int a = 0; a < kQ; ++a) {
    wd[a] = td[a] = inf;
    wi[a] = INT_MAX;
  }

  // The sweep starts at the tile across from the block's queries (ref row
  // (query row) * m / n) and wraps around: on curve-sorted clouds (K4, and
  // K1 on the Morton pyramid) those refs are the nearest, so the threshold
  // is tight from the first tile on and few candidates follow. The order
  // does not change the result.
  const int n_tiles = (j_hi - j_lo + kTile - 1) / kTile;
  const long long across = ((long long)q0 + kQ * kWarps / split / 2) * m / n;
  const int t0 = (int)((min(max(across, (long long)j_lo), (long long)j_hi - 1) - j_lo) / kTile);

  // thread tid stages ref tid of a tile: each coordinate one 4-byte
  // cp.async (coordinates past d zero-filled); a ref past the range is a
  // NaN record, whose distance passes no test
  auto tile_start = [&](int t) {
    const int tt = t + t0;
    return j_lo + (tt < n_tiles ? tt : tt - n_tiles) * kTile;
  };
  auto stage = [&](int t) {
    if (t < n_tiles) {
      const int j = tile_start(t) + tid;
      float4* rec = tile + (size_t)(t % kStages) * R * kTile + tid;
      if (j < j_hi) {
        const float* src = rb + (size_t)j * d;
#pragma unroll
        for (int c = 0; c < 4 * R; ++c)
          if (c < DP)
            cp_async4(reinterpret_cast<float*>(rec + (c / 4) * kTile) + c % 4,
                      c < d ? src + c : src, c < d);
      } else {
#pragma unroll
        for (int c = 0; c < R; ++c)
          rec[c * kTile] = make_float4(__int_as_float(0x7fc00000), 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) stage(t);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    stage(t + kStages - 1);
    const float4* cur = tile + (size_t)(t % kStages) * R * kTile;
    const int j0 = tile_start(t);
    const int chunks = (min(kTile, j_hi - j0) + 31) >> 5;
    for (int ch = part; ch < chunks; ch += split) {
      const int r = (ch << 5) + lane;
      const int j = j0 + r;
      float4 rec[R];
#pragma unroll
      for (int c = 0; c < R; ++c) rec[c] = cur[c * kTile + r];
      float acc[kQ];
#pragma unroll
      for (int a = 0; a < kQ; ++a) acc[a] = sq_dist<DP>(q[a], rec);
      if constexpr (kArgmin) {
#pragma unroll
        for (int a = 0; a < kQ; ++a)
          if (less(acc[a], j, wd[a], wi[a])) {
            wd[a] = acc[a];
            wi[a] = j;
          }
      } else {
        // one vote when no query has a candidate, the common case
        bool any = false;
#pragma unroll
        for (int a = 0; a < kQ; ++a) any |= acc[a] <= td[a];
        if (__any_sync(kAll, any)) {
#pragma unroll
          for (int a = 0; a < kQ; ++a) {
            const unsigned mask = __ballot_sync(kAll, acc[a] <= td[a]);
            if (mask) insert(wd[a], wi[a], td[a], mask, acc[a], j, lane, k);
          }
        }
      }
    }
  }

  if constexpr (kArgmin) {
    // each lane's minimum to every lane, then the queue (min, +inf, ...)
#pragma unroll
    for (int a = 0; a < kQ; ++a) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(kAll, wd[a], o);
        const int oi = __shfl_xor_sync(kAll, wi[a], o);
        if (less(od, oi, wd[a], wi[a])) {
          wd[a] = od;
          wi[a] = oi;
        }
      }
      if (lane != 0) {
        wd[a] = inf;
        wi[a] = INT_MAX;
      }
    }
  }

  if (split > 1) {
#pragma unroll
    for (int a = 0; a < kQ; ++a) {
      red_d[warp][a][lane] = wd[a];
      red_i[warp][a][lane] = wi[a];
    }
    __syncthreads();
    if (part != 0) return;
    for (int p = 1; p < split; ++p)
#pragma unroll
      for (int a = 0; a < kQ; ++a)   // the other queue reversed is descending
        merge_into(wd[a], wi[a], red_d[warp + p][a][31 - lane],
                   red_i[warp + p][a][31 - lane], lane);
  }

  if (lane < k) {
#pragma unroll
    for (int a = 0; a < kQ; ++a)
      if (qg + a < n) {
        const size_t o = ((size_t)b * n + qg + a) * k + lane;
        idx_out[o] = wi[a];
        dist_out[o] = wd[a];
      }
  }
}

constexpr int kMaxDevices = 64;

// Resident blocks of one kernel instance on the current device, SMs x
// blocks per SM: asked of the runtime at the first call per device and
// cached, so that a later call costs the host only its launch.
template <bool kArgmin, int DP>
cudaError_t block_slots(int* slots) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t once_err[kMaxDevices];
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] {
    int sms = 0, per_sm = 0;
    once_err[dev] = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (once_err[dev] == cudaSuccess)
      once_err[dev] = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, knn_kernel<kArgmin, DP>, kThreads, 0);
    if (once_err[dev] == cudaSuccess && per_sm < 1) once_err[dev] = cudaErrorInvalidConfiguration;
    cached[dev].store(sms * per_sm, std::memory_order_relaxed);
  });
  if (once_err[dev] != cudaSuccess) return once_err[dev];
  *slots = cached[dev].load(std::memory_order_relaxed);
  return cudaSuccess;
}

// Warps per query group: the largest split whose blocks all fit the card's
// resident blocks at once, else 1. Splitting repeats the selection in every
// split warp (each sees about k + k ln(refs / (split k)) candidates) and adds
// a merge, so it pays only where it fills SMs that would otherwise idle.
inline int pick_split(long long query_groups, int slots) {
  int split = 1;
  while (split < kWarps && (query_groups * split * 2 + kWarps - 1) / kWarps <= slots)
    split *= 2;
  return split;
}

template <bool kArgmin, int DP>
cudaError_t launch_form(const float* query, const float* ref, const int* win_start,
                        int win_rows, long long* idx, float* dist, int batch, int n,
                        int m, int d, int k, cudaStream_t st) {
  int slots = 0;
  cudaError_t err = block_slots<kArgmin, DP>(&slots);
  if (err != cudaSuccess) return err;
  // a window tile's groups never share a block with another tile's: 128 rows
  // hold whole blocks at every split
  const int split = pick_split((long long)batch * ((n + kQ - 1) / kQ), slots);
  const int per_block = kQ * kWarps / split;
  const dim3 grid((n + per_block - 1) / per_block, batch);
  knn_kernel<kArgmin, DP><<<grid, kThreads, 0, st>>>(query, ref, win_start, win_rows, idx,
                                                     dist, n, m, d, k, split);
  return cudaGetLastError();
}

// Launches the search on `stream`; returns a CUDA error code (0 on
// success). The caller guarantees k refs in every range.
inline int launch(const float* query, const float* ref, const int* win_start,
                  int win_rows, long long* idx, float* dist, int batch, int n,
                  int m, int d, int k, void* stream) {
  if (k < 1 || k > 32 || k > m || d < 1 || d > kDimMax || n < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k == 1)
    err = d == 3 ? launch_form<true, 3>(query, ref, win_start, win_rows, idx, dist, batch,
                                        n, m, d, k, st)
                 : launch_form<true, kDimMax>(query, ref, win_start, win_rows, idx, dist,
                                              batch, n, m, d, k, st);
  else
    err = d == 3 ? launch_form<false, 3>(query, ref, win_start, win_rows, idx, dist, batch,
                                         n, m, d, k, st)
                 : launch_form<false, kDimMax>(query, ref, win_start, win_rows, idx, dist,
                                               batch, n, m, d, k, st);
  return (int)err;
}

}  // namespace knn_select
