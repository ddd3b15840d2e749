// K2: fused descriptor distance + argmin (the correspondence search).
//
// Replaces the TPU kernel deepsir_tpu/ops/pallas_match.py::match_argmin_single
// (kernel body `_match_kernel`). Same function: for every src row, the ref
// row minimising |r|^2 - 2 s.r (|s|^2 is constant per row), ties to the
// lowest ref index, never materialising the (N, M) distance matrix. |r|^2 is
// computed by the wrapper, as the TPU wrapper does outside its kernel.
//
// What bounds it on the H100: arithmetic. At the protocol (N = M = 18000,
// C = 64) it is 2 * 18000^2 * 64 = 41.5 GFLOP of fp32 multiply-add against
// 9.2 MB of input, ~4500 FLOP per byte: far past the memory roofline. The
// precision rule keeps it on the CUDA cores in fp32 (no TF32 or bf16 tensor
// cores), so the bound is the 67 TFLOP/s fp32 rate, about 0.6 ms.
// What the design does about it: a block owns 64 src rows and walks the ref
// rows in tiles of 64; 32-channel slices of both tiles are staged in shared
// memory (padded rows: conflict-free stores and reads) and each of the 256
// threads accumulates a 4 x 4 register tile of dot products with FMAs, so
// every shared-memory value read feeds 4 FMAs. The epilogue folds each tile
// into a running (min, argmin) per row held in registers; a warp-shuffle
// reduction over the 16 threads that share a row applies the lowest-index
// tie rule at the end.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kBM = 64;        // src rows per block
constexpr int kBN = 64;        // ref rows per tile
constexpr int kBK = 32;        // channels per shared-memory slice
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
match_argmin_kernel(const float* __restrict__ src, const float* __restrict__ ref,
                    const float* __restrict__ ref_sq, long long* __restrict__ out,
                    int n, int m, int c) {
  __shared__ float as[kBM][kBK + 1];
  __shared__ float bs[kBN][kBK + 1];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  src += (size_t)b * n * c;
  ref += (size_t)b * m * c;
  ref_sq += (size_t)b * m;

  float best_d[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

    // columns of this thread ascend with j, tiles ascend with col0: a strict
    // compare keeps the lowest index among equal distances
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < m) {
        const float rs = ref_sq[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dv = rs - 2.f * acc[i][j];
          if (dv < best_d[i]) {
            best_d[i] = dv;
            best_i[i] = col;
          }
        }
      }
    }
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

}  // namespace

// src (batch, n, c), ref (batch, m, c), ref_sq (batch, m) f32 contiguous;
// writes out (batch, n) int64. Requires 1 <= c <= 128. Returns the launch's
// cudaGetLastError() value (0 on success).
extern "C" int match_argmin_launch(const float* src, const float* ref,
                                   const float* ref_sq, long long* out,
                                   int batch, int n, int m, int c,
                                   void* stream) {
  if (c < 1 || c > 128 || n < 1 || m < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kBM - 1) / kBM, batch);
  match_argmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, ref, ref_sq, out, n, m, c);
  return (int)cudaGetLastError();
}
