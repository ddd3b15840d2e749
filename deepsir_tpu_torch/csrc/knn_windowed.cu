// K4: exact k-nearest-neighbour search within a curve-rank window.
//
// Replaces the TPU kernel deepsir_tpu/ops/pallas_knn.py::knn_topk_windowed_single
// (kernel body `_knn_windowed_kernel`). Same function: for clouds sorted along a Morton
// curve, every 128-row query tile searches only the refs of its window of
// deepsir_tpu/ops/window.py (width blocks of 512 rows from start_block(i)),
// and is exact within it: ascending, ties to the lowest ref index, every
// index inside the window. Unlike the TPU kernel the distances are exact
// fp32, not quantised into packed int32 keys.
//
// The window comes in as a per-tile table of first rows that the wrapper
// computes on the host with deepsir_tpu_torch/ops/window.py, so the kernel
// and its plain version (ops/cuda_knn.py::knn_topk_windowed_plain) read one
// definition of the window. The search is K1's (knn_select.cuh) with the
// ref range cut to the window, so its distances are bit-identical to the
// plain version's and indices must be equal.
//
// What bounds it on the H100: at the Morton pyramid's level-0 self-search
// (18000 queries, a 1536-row window) it is 2.8e7 pair distances of 8 fp32
// operations, 3.3 us at 67 TFLOP/s, against ~0.5 MB of input and output:
// arithmetic, but with only 1536 refs per query the selection (about
// k + k ln(1536 / k) candidates per query) weighs as much as the distances.
// What the design does about it: one launch serves the whole batch (grid.y);
// a block's queries share one window, so each staged ref tile serves all of
// them, and only the window's 3 x 512 rows are read; the sweep starts at the
// window rows across from the block's queries, their nearest refs on a
// curve-sorted cloud, so the warp-shared queue of knn_select.cuh starts with
// a tight threshold and admits few candidates after the first tile.
#include "knn_select.cuh"

// query (batch, n, d), ref (batch, m, d) f32 contiguous; win_start
// (ceil(n / 128),) int32 first ref row of each query tile's window, which is
// [win_start[t], min(m, win_start[t] + win_rows)); writes idx and dist
// (batch, n, k). Requires 1 <= k <= 32, k refs in every window, 1 <= d <= 8.
// Returns a CUDA error code (0 on success).
extern "C" int knn_windowed_launch(const float* query, const float* ref,
                                   const int* win_start, int win_rows,
                                   long long* idx, float* dist, int batch,
                                   int n, int m, int d, int k, void* stream) {
  if (win_start == nullptr || win_rows < k) return (int)cudaErrorInvalidValue;
  return knn_select::launch(query, ref, win_start, win_rows, idx, dist, batch,
                            n, m, d, k, stream);
}
