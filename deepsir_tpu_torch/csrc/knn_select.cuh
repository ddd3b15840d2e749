// The exact k-nearest-neighbour search shared by K1 (knn_topk.cu, whole ref
// array) and K4 (knn_windowed.cu, a curve-rank window of it per query tile).
//
// A block owns kQueries query rows; each query is split over kSplit threads
// that scan interleaved ref columns of [j_lo, j_hi), where the range is the
// whole ref array (K1) or the window of the block's 128-row query tile (K4).
// Ref tiles are staged once per block in shared memory, every query
// coordinate lives in registers, and each thread keeps a sorted (dist, idx)
// list of KC entries in registers with a fully unrolled insertion; the kSplit
// lists of a query are merged through shared memory at the end.
//
// Tie rule: every thread visits its refs in ascending index order and a
// candidate displaces a kept entry only when strictly closer, so each list is
// ordered by (dist, idx); the merge compares (dist, idx) lexicographically.
// The distance is sum_d (q_d - r_d)^2 summed over d in order with the
// round-to-nearest intrinsics, so nvcc cannot contract it into FMAs and the
// result is bit-identical to the plain PyTorch versions
// (deepsir_tpu_torch/ops/cuda_knn.py): indices must be equal.
#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace knn_select {

constexpr int kSplit = 4;                     // threads per query
constexpr int kQueries = 32;                  // queries per block
constexpr int kThreads = kSplit * kQueries;   // 128
constexpr int kTile = 256;                    // refs per shared-memory tile
constexpr int kDimMax = 8;
constexpr int kWindowTile = 128;              // query rows per window (window.py TQ)
static_assert(kWindowTile % kQueries == 0, "a block must lie in one window tile");

// win_start == nullptr: every query searches refs [0, m). Otherwise the
// queries of window tile t = row / kWindowTile search
// [win_start[t], min(m, win_start[t] + win_rows)).
template <int KC, int DP>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
           const int* __restrict__ win_start, int win_rows,
           long long* __restrict__ idx_out, float* __restrict__ dist_out,
           int n, int m, int d, int k) {
  __shared__ float tile[DP * kTile];
  __shared__ float md[kThreads * KC];
  __shared__ int mi[kThreads * KC];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lq = tid / kSplit;                // query slot in the block
  const int s = tid % kSplit;                 // ref interleave of this thread
  const int q0 = blockIdx.x * kQueries;
  const int qi = q0 + lq;
  const float* qb = query + (size_t)b * n * d;
  const float* rb = ref + (size_t)b * m * d;
  int j_lo = 0, j_hi = m;
  if (win_start != nullptr) {
    j_lo = win_start[q0 / kWindowTile];
    j_hi = min(m, j_lo + win_rows);
  }

  // coordinates past d are zero on both sides: they add exact zeros
  float q[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c)
    q[c] = (qi < n && c < d) ? qb[(size_t)qi * d + c] : 0.f;

  float bd[KC];
  int bi[KC];
#pragma unroll
  for (int t = 0; t < KC; ++t) {
    bd[t] = __int_as_float(0x7f800000);       // +inf
    bi[t] = INT_MAX;
  }

  for (int j0 = j_lo; j0 < j_hi; j0 += kTile) {
    const int tl = min(kTile, j_hi - j0);
    __syncthreads();
    for (int e = tid; e < tl * DP; e += kThreads) {
      const int r = e / DP, c = e - r * DP;
      tile[c * kTile + r] = c < d ? rb[(size_t)(j0 + r) * d + c] : 0.f;
    }
    __syncthreads();
    for (int r = s; r < tl; r += kSplit) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        const float diff = __fsub_rn(q[c], tile[c * kTile + r]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      if (acc < bd[KC - 1]) {
        const int j = j0 + r;
        // insert after every kept entry that is not farther (ties keep the
        // lower index first); shift the farther ones right by one
#pragma unroll
        for (int t = KC - 1; t >= 1; --t) {
          const bool shift = acc < bd[t - 1];
          const bool here = !shift && acc < bd[t];
          bd[t] = shift ? bd[t - 1] : (here ? acc : bd[t]);
          bi[t] = shift ? bi[t - 1] : (here ? j : bi[t]);
        }
        if (acc < bd[0]) {
          bd[0] = acc;
          bi[0] = j;
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < KC; ++t) {
    md[tid * KC + t] = bd[t];
    mi[tid * KC + t] = bi[t];
  }
  __syncthreads();
  if (s != 0 || qi >= n) return;

  // merge the kSplit sorted lists of this query by (dist, idx)
  const int base = lq * kSplit;
  int p[kSplit];
#pragma unroll
  for (int w = 0; w < kSplit; ++w) p[w] = 0;
  const size_t out0 = ((size_t)b * n + qi) * k;
  for (int o = 0; o < k; ++o) {
    float best = __int_as_float(0x7f800000);
    int bidx = INT_MAX;
    int which = 0;
#pragma unroll
    for (int w = 0; w < kSplit; ++w) {
      if (p[w] < KC) {
        const float dv = md[(base + w) * KC + p[w]];
        const int iv = mi[(base + w) * KC + p[w]];
        if (dv < best || (dv == best && iv < bidx)) {
          best = dv;
          bidx = iv;
          which = w;
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kSplit; ++w) p[w] += (w == which);
    idx_out[out0 + o] = bidx;
    dist_out[out0 + o] = best;
  }
}

template <int KC>
void launch_kc(const float* query, const float* ref, const int* win_start,
               int win_rows, long long* idx, float* dist, int batch, int n,
               int m, int d, int k, cudaStream_t stream) {
  const dim3 grid((n + kQueries - 1) / kQueries, batch);
  if (d == 3)
    knn_kernel<KC, 3><<<grid, kThreads, 0, stream>>>(
        query, ref, win_start, win_rows, idx, dist, n, m, d, k);
  else
    knn_kernel<KC, kDimMax><<<grid, kThreads, 0, stream>>>(
        query, ref, win_start, win_rows, idx, dist, n, m, d, k);
}

// Launches the search on `stream`; returns the launch's cudaGetLastError()
// value (0 on success). The caller guarantees k refs in every range.
inline int launch(const float* query, const float* ref, const int* win_start,
                  int win_rows, long long* idx, float* dist, int batch, int n,
                  int m, int d, int k, void* stream) {
  if (k < 1 || k > 32 || k > m || d < 1 || d > kDimMax || n < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1)
    launch_kc<1>(query, ref, win_start, win_rows, idx, dist, batch, n, m, d, k, st);
  else if (k <= 4)
    launch_kc<4>(query, ref, win_start, win_rows, idx, dist, batch, n, m, d, k, st);
  else if (k <= 8)
    launch_kc<8>(query, ref, win_start, win_rows, idx, dist, batch, n, m, d, k, st);
  else if (k <= 16)
    launch_kc<16>(query, ref, win_start, win_rows, idx, dist, batch, n, m, d, k, st);
  else
    launch_kc<32>(query, ref, win_start, win_rows, idx, dist, batch, n, m, d, k, st);
  return (int)cudaGetLastError();
}

}  // namespace knn_select
