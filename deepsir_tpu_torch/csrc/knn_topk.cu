// K1: exact k-nearest-neighbour search for the RandLA index pyramid.
//
// Replaces the TPU kernel deepsir_tpu/ops/pallas_knn.py::knn_topk_single
// (kernel body `_knn_kernel`). Same function: fused squared distance by
// direct subtraction over D <= 8 coordinates and a top-k per query row,
// ascending, ties to the lowest ref index. Unlike the TPU kernel it is exact:
// no bucketed partial reduce and no quantised distance keys.
//
// What bounds it on the H100: arithmetic. The pyramid's level-0 self-search
// at 18000 points is 3.24e8 pair distances (3 sub + 3 mul + 2 add each)
// against 18000 * 3 * 4 bytes of input: the data fit in L2 many times over,
// so bytes are nothing and the CUDA cores' fp32 issue rate is the limit;
// the bit-exact rule forbids FMA contraction, so with the rejection test
// about 9 issued instructions per pair are the floor. What the design does
// about it (knn_select.cuh, shared with K4): a warp carries 4 queries in
// registers, so one 16-byte shared-memory load of a ref serves 4 pair
// distances; the lanes of a warp share one queue per query, whose k-th
// entry has seen 32x the refs a per-lane list would, so almost every ref is
// rejected by one compare and a warp-wide ballot, and the rare insertion is
// warp-synchronous rather than a divergent per-lane path; a block's warps
// split the ref sweep when the queries alone cannot fill the SMs. Its
// distances are bit-identical to the plain PyTorch version
// (deepsir_tpu_torch/ops/cuda_knn.py::knn_topk_plain): indices must be equal.
#include "knn_select.cuh"

// query (batch, n, d), ref (batch, m, d) f32 contiguous; writes idx and dist
// (batch, n, k). Requires 1 <= k <= min(m, 32), 1 <= d <= 8. Returns a
// CUDA error code (0 on success).
extern "C" int knn_topk_launch(const float* query, const float* ref,
                               long long* idx, float* dist, int batch, int n,
                               int m, int d, int k, void* stream) {
  return knn_select::launch(query, ref, nullptr, 0, idx, dist, batch, n, m, d,
                            k, stream);
}
