// K3: fused descriptor distance + argmin in both directions (the
// correspondence search of the mutual gate and the `recip` inlier channel).
//
// Replaces the TPU kernel deepsir_tpu/ops/pallas_match.py::match_argmin_bidirectional
// (kernel body `_match_bidir_kernel`). Same function, in one pass over the distance tiles
// and never materialising the (N, M) matrix:
// - row direction, as K2 (match_argmin.cu): for every src row the ref row
//   minimising |r|^2 - 2 s.r, ties to the lowest ref index;
// - column direction: for every ref row the src row minimising the full
//   distance (|r|^2 - 2 s.r) + |s|^2, ties to the lowest src index.
// |s|^2 and |r|^2 come from the wrapper, as the TPU wrapper computes them
// outside its kernel.
//
// What bounds it on the H100: arithmetic, as K2. At the protocol (N = M =
// 18000, C = 64) it is 2 * 18000^2 * 64 = 41.5 GFLOP of fp32 multiply-add
// against 9.4 MB of input: the precision rule keeps it on the CUDA cores in
// fp32, so the bound is the 67 TFLOP/s fp32 rate, about 0.62 ms. The column
// direction adds one add, one compare and a 64-bit min per distance.
//
// What the design does about it: the dot products are K2's (a block owns 64
// src rows and walks the ref rows in tiles of 64, 32-channel slices staged in
// shared memory, a 4 x 4 register tile of FMAs per thread). The TPU kernel
// carries the column minimum across its sequential query sweep in a
// full-width scratch; here blocks run in parallel and in no order, so the
// column minimum crosses blocks through 64-bit atomics. Each tile's column
// minima over the block's 64 rows are reduced in registers, one warp shuffle
// and shared memory, then the block issues one atomicMin per column into the
// (B, M) int64 output, which the launcher first fills with all ones. The
// atomic's key is (orderable_bits(d) << 32) | src_row, where orderable_bits
// maps fp32 to a uint32 of the same order (negative distances, which
// rounding can give, order correctly; -0 is folded into +0). A minimum does
// not depend on the order of the atomics, so the result is deterministic and
// ties go to the lowest src row, as the TPU kernel's strict compare over an
// ascending sweep gives. A second small kernel keeps the key's low 32 bits.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kBM = 64;        // src rows per block
constexpr int kBN = 64;        // ref rows per tile
constexpr int kBK = 32;        // channels per shared-memory slice
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWarps = kThreads / 32;

typedef unsigned long long u64;

__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }

// fp32 -> uint32 with the same order (for non-NaN values)
__device__ __forceinline__ unsigned int orderable_bits(float f) {
  const unsigned int u = __float_as_uint(__fadd_rn(f, 0.f));   // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
match_bidir_kernel(const float* __restrict__ src, const float* __restrict__ ref,
                   const float* __restrict__ src_sq,
                   const float* __restrict__ ref_sq, long long* __restrict__ out,
                   u64* __restrict__ col_key, int n, int m, int c) {
  __shared__ float as[kBM][kBK + 1];
  __shared__ float bs[kBN][kBK + 1];
  __shared__ u64 ck[kWarps][kBN];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;
  src += (size_t)b * n * c;
  ref += (size_t)b * m * c;
  src_sq += (size_t)b * n;
  ref_sq += (size_t)b * m;
  col_key += (size_t)b * m;

  float ss[4];
  float best_d[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    ss[i] = row < n ? src_sq[row] : 0.f;
    best_d[i] = __int_as_float(0x7f800000);
    best_i[i] = INT_MAX;
  }

  for (int col0 = 0; col0 < m; col0 += kBN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < c; k0 += kBK) {
      __syncthreads();
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK;
        const int gk = k0 + kk;
        const int gr = row0 + r, gc = col0 + r;
        as[r][kk] = (gr < n && gk < c) ? src[(size_t)gr * c + gk] : 0.f;
        bs[r][kk] = (gc < m && gk < c) ? ref[(size_t)gc * c + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[ty * 4 + i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = bs[tx + 16 * j][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
    }

    // row direction: columns of this thread ascend with j, tiles ascend with
    // col0, so a strict compare keeps the lowest index among equal distances.
    // Column direction: the (distance, row) key minimum over this thread's
    // rows; rows past n and columns past m never compete.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      u64 key = ~0ull;
      if (col < m) {
        const float rs = ref_sq[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + ty * 4 + i;
          const float dv = rs - 2.f * acc[i][j];
          if (dv < best_d[i]) {
            best_d[i] = dv;
            best_i[i] = col;
          }
          if (row < n)
            key = kmin(key, ((u64)orderable_bits(dv + ss[i]) << 32) |
                                (unsigned int)row);
        }
      }
      // lanes l and l ^ 16 hold the same column for row groups 2w and 2w+1
      key = kmin(key, __shfl_xor_sync(0xffffffffu, key, 16));
      if (lane < 16) ck[warp][tx + 16 * j] = key;
    }
    __syncthreads();
    if (tid < kBN && col0 + tid < m) {
      u64 key = ck[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) key = kmin(key, ck[w][tid]);
      atomicMin(&col_key[col0 + tid], key);
    }
    // the next tile's first __syncthreads() orders these reads of ck before
    // its next writes
  }

  // the 16 threads of a row group are lanes [0,16) or [16,32) of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float dv = best_d[i];
    int iv = best_i[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, dv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, iv, off);
      if (od < dv || (od == dv && oi < iv)) {
        dv = od;
        iv = oi;
      }
    }
    const int row = row0 + ty * 4 + i;
    if (tx == 0 && row < n) out[(size_t)b * n + row] = iv == INT_MAX ? 0 : iv;
  }
}

// keys -> src row indices, in place
__global__ void key_low_words(long long* __restrict__ keys, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) keys[i] = (long long)((u64)keys[i] & 0xffffffffull);
}

}  // namespace

// src (batch, n, c), ref (batch, m, c), src_sq (batch, n), ref_sq (batch, m)
// f32 contiguous; writes idx (batch, n) and ridx (batch, m) int64. Requires
// 1 <= c <= 128. Three launches on `stream` (fill, search, key -> index);
// returns the first non-zero CUDA error code, or 0.
extern "C" int match_bidir_launch(const float* src, const float* ref,
                                  const float* src_sq, const float* ref_sq,
                                  long long* idx, long long* ridx, int batch,
                                  int n, int m, int c, void* stream) {
  if (c < 1 || c > 128 || n < 1 || m < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)batch * m;
  cudaError_t err = cudaMemsetAsync(ridx, 0xff, sizeof(long long) * total, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBM - 1) / kBM, batch);
  match_bidir_kernel<<<grid, kThreads, 0, st>>>(
      src, ref, src_sq, ref_sq, idx, reinterpret_cast<u64*>(ridx), n, m, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  key_low_words<<<(unsigned int)((total + 255) / 256), 256, 0, st>>>(ridx, total);
  return (int)cudaGetLastError();
}
