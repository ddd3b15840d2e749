// K3: fused descriptor distance + argmin in both directions (the
// correspondence search of the mutual gate and the `recip` inlier channel).
//
// Replaces the TPU kernel deepsir_tpu/ops/pallas_match.py::match_argmin_bidirectional
// (kernel body `_match_bidir_kernel`). Same function, in one pass over the
// distance tiles and never materialising the (N, M) matrix:
// - row direction, as K2 (match_argmin.cu): for every src row the ref row
//   minimising |r|^2 - 2 s.r, ties to the lowest ref index;
// - column direction: for every ref row the src row minimising the full
//   distance (|r|^2 - 2 s.r) + |s|^2, ties to the lowest src index.
// With `low_precision` the products take bf16 operands with fp32
// accumulation, as the TPU kernel's do. |s|^2 and |r|^2 come from the
// wrapper, from the fp32 inputs, as the TPU wrapper computes them outside
// its kernel.
//
// What bounds it on the H100: arithmetic, as K2. At the protocol (N = M =
// 18000, C = 64, B = 1) it is 41.5 GFLOP of products against 9.7 MB of
// input: fp32-grade as 3xTF32 on the tensor cores, 124.4 GFLOP at
// 495 TFLOP/s, 0.25 ms (0.62 ms as fp32 FMAs on the CUDA cores); the bf16
// form 0.042 ms at 989 TFLOP/s (4.6 MB of bf16 operands take 1.4 us). The
// column direction adds an add, a compare and a select per distance, three
// shuffle steps per column per warp and one 64-bit atomicMin per column per
// block.
// What the design does about it: the tensor-core core of match_core.cuh,
// shared with K2. The TPU kernel carries the column minimum across its
// sequential query sweep in a full-width scratch; here blocks run in
// parallel and in no order, so each block reduces its 128 rows per column
// (registers, shuffles over the fragment's row groups, shared memory across
// the 4 row warps) and merges with one atomicMin per column of the key
// (orderable(d) << 32) | src_row into the (B, M) int64 output, which the
// launcher first fills with all ones. The minimum does not depend on the
// order of the atomics, so the result is deterministic and ties go to the
// lowest src row, as the TPU kernel's strict compare over an ascending sweep
// gives.
#include "match_core.cuh"

// src (batch, n, c), ref (batch, m, c), src_sq (batch, n), ref_sq (batch, m)
// f32 contiguous; writes idx (batch, n) and ridx (batch, m) int64. Requires
// 1 <= c <= 128. low_precision != 0 selects bf16 operands, else the
// fp32-grade 3xTF32 form. Four operations on `stream` (two fills, search,
// keys -> indices); returns the first non-zero CUDA error code, or 0.
extern "C" int match_bidir_launch(const float* src, const float* ref,
                                  const float* src_sq, const float* ref_sq,
                                  long long* idx, long long* ridx, int batch,
                                  int n, int m, int c, int low_precision,
                                  void* stream) {
  return match_core::launch<true>(src, ref, src_sq, ref_sq, idx, ridx, batch, n, m,
                                  c, low_precision, stream);
}
