// K2: fused descriptor distance + argmin (the correspondence search).
//
// Replaces the TPU kernel deepsir_tpu/ops/pallas_match.py::match_argmin_single
// (kernel body `_match_kernel`). Same function: for every src row, the ref
// row minimising |r|^2 - 2 s.r (|s|^2 is constant per row), ties to the
// lowest ref index, never materialising the (N, M) distance matrix; with
// `low_precision` the products take bf16 operands with fp32 accumulation, as
// the TPU kernel's do. |r|^2 comes from the wrapper, from the fp32 inputs,
// as the TPU wrapper computes it outside its kernel.
//
// What bounds it on the H100: arithmetic. At the protocol (N = M = 18000,
// C = 64, B = 1) it is 2 * 18000^2 * 64 = 41.5 GFLOP against 9.4 MB of
// input. Fp32-grade, as three TF32 tensor-core products (3xTF32), that is
// 124.4 GFLOP at 495 TFLOP/s: 0.25 ms (fp32 FMAs on the CUDA cores would be
// 0.62 ms at 67 TFLOP/s). The bf16 form is 41.5 GFLOP at 989 TFLOP/s:
// 0.042 ms of operations (its 4.6 MB of bf16 operands take 1.4 us).
// What the design does about it: the products run on the tensor cores with
// `mma.sync`, in 128 x 64 block tiles fed by a 3-stage `cp.async` ring, and
// the ref sweep is split across blocks so that 141 row blocks fill 132 SMs;
// the argmin is reduced from the accumulators in registers and merged across
// blocks with 64-bit atomics. All of it is the core in match_core.cuh,
// shared with K3.
#include "match_core.cuh"

// src (batch, n, c), ref (batch, m, c), ref_sq (batch, m) f32 contiguous;
// writes out (batch, n) int64. Requires 1 <= c <= 128. low_precision != 0
// selects bf16 operands, else the fp32-grade 3xTF32 form. Three operations
// on `stream` (fill, search, key -> index); returns the first non-zero CUDA
// error code, or 0.
extern "C" int match_argmin_launch(const float* src, const float* ref,
                                   const float* ref_sq, long long* out,
                                   int batch, int n, int m, int c,
                                   int low_precision, void* stream) {
  return match_core::launch<false>(src, ref, nullptr, ref_sq, out, nullptr, batch,
                                   n, m, c, low_precision, stream);
}
