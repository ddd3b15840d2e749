// The feat pipeline's circle loss, forward and backward: the per-row and
// per-column reductions of deepsir_tpu_torch/losses/detdes.py's
// `circle_loss_tiled`, never holding an (N1, N2) tensor in device memory.
//
// It replaces no TPU kernel: the JAX package computes this loss with plain
// XLA (deepsir_tpu/losses/detdes.py), and the port's plain version, the
// column-tiled loop in ops/cuda_circle.py::circle_rows_plain, makes ~30
// elementwise passes over each 18000 x 1500 tile and keeps ~11 GiB of
// residuals for autograd.
//
// What bounds it on the H100: the descriptor products. For anchors a (N1, C)
// and positives p (N2, C) every entry needs |a_i - p_j| by the expansion
// |a|^2 + |p|^2 - 2 a.p, so the forward is one (N1 x N2 x C) product and the
// backward three (the distances again, and the two reductions G' p and
// G'^T a). At N1 = N2 = 18000, C = 64 that is 41.5 GFLOP a product: 0.25 ms
// at the fp32-grade rate of three TF32 tensor-core products (K2 and K3's
// scheme), 0.62 ms at the 67 TFLOP/s of fp32 FMAs, which this kernel uses
// (fp32 grade is required: a single TF32 product moves the loss by 4.5e-6 of
// itself). Beside the products each entry takes
// two square roots, an exponential, the masks and the point distance (~60
// instructions against the product's 64 FMAs), and the input is only 9.4 MB,
// so the kernels are bound by issue, not bytes. What the design does about
// it: 64 x 64 block tiles, each of 256 threads holding a 4 x 4 micro-tile of
// the product in registers (FFMA, float4 loads from shared memory with a
// 68-float row stride, no bank conflicts); in the forward, column tiles
// stream through a double-buffered `cp.async` ring and the sweep is split
// over blocks so that ~8 waves fill the card; the per-entry work is written
// so that the common entries (out of radius, descriptor distance above the
// margin) skip the exponentials. Nothing uses float atomics, so two runs give
// the same bits: the row minimum of pass 1 merges by integer atomicMin on
// non-negative floats, which is exact, and every sum is merged by a later
// kernel in a fixed order.
//
// The passes, all on the caller's stream:
//   prep      the points' (x, y, z, |f|^2) and pass 1's buffers;
//   pass 1    each anchor's minimum of dist_pc * (dist_pc < radius), the
//             zero-before-min quirk, and whether any pair is in radius;
//   forward   every entry's masks, the positive and negative terms, the row
//             logsumexps (online, accumulated in double), the detector's
//             row max over positives and row min, with tie counts, and each
//             column's sum over the block's rows;
//   merge     the splits and the row blocks, in order;
//   backward  the coefficient g on dist_feat of every entry, recomputed from
//             the saved row and column statistics, times d dist_feat / d sq,
//             written one column tile of the plain version at a time
//             (N1 x width, width <= 1500 in the feat step), with its row and
//             column sums; the wrapper reduces each tile into d anc and
//             d pos with the same fp32 products that autograd runs on the
//             plain version. Those long fp32 sums drop the smallest terms
//             (~3e-5 of the heads' gradients on the feat step, measured
//             against float64); reducing here in float64 would be ten times
//             closer to exact but that far from the plain version, which the
//             training reference holds the step to. The sums only scale
//             each descriptor's own direction, which the l2_normalize
//             before the loss takes out of its gradient, so their order
//             does not matter.
//
// The reference's quirks are kept (losses/detdes.py's docstring lists them):
// point distances by direct difference with every operation rounded on its
// own (as K1), so the masks are decided on exact values; the positive mask
// is `dist_pc == dist_min`, tested as `x == 0` where dist_min is 0 and on the
// rounded square root otherwise; the radius test `sqrt_rn(x) < r` is the
// exact `x < thres_sq` with thres_sq the least float whose root reaches r
// (the wrapper finds it); every masked entry adds exp(0) to its logsumexp;
// the circle weights carry no gradient; the detector's gradient goes to the
// row's max and min entries, split evenly among exact ties.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;            // rows of a block, columns of a sweep step
constexpr int CH = 64;              // channels (the wrapper zero-pads fewer)
constexpr int LD = CH + 4;          // shared-memory row stride of a feature tile
constexpr int THREADS = 256;        // 16 x 16 threads, 4 x 4 entries each
constexpr float BIG = 1e5f;
constexpr float EPS = 1e-12f;
constexpr unsigned IN_RADIUS = 1u, OUT_OF_RADIUS = 2u;
constexpr unsigned FULL = 0xffffffffu;

struct Loss {
  float thres_sq;     // x < thres_sq  <=>  sqrt_rn(x) < thres_radius
  float log_scale, pos_margin, neg_margin;
  float shift;        // log_scale * max(neg_margin, 0)^2, the largest negative term
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + TILE) of a (n, CH) feature array into a (TILE, LD) tile;
// rows past n are zero-filled.
__device__ __forceinline__ void load_feat(float* dst, const float* src, int row0, int n) {
  for (int q = threadIdx.x; q < TILE * CH / 4; q += THREADS) {
    int r = q / (CH / 4), c4 = q % (CH / 4);
    int row = row0 + r;
    bool ok = row < n;
    cp_async16(dst + r * LD + c4 * 4, src + static_cast<size_t>(ok ? row : 0) * CH + c4 * 4,
               ok ? 16 : 0);
  }
}

// V float4s per point of rows [row0, row0 + TILE) into dst; past n zero-filled.
template <int V>
__device__ __forceinline__ void load_vecs(float4* dst, const float4* src, int row0, int n) {
  for (int q = threadIdx.x; q < TILE * V; q += THREADS) {
    int row = row0 + q / V;
    bool ok = row < n;
    cp_async16(dst + q, src + static_cast<size_t>(ok ? row : 0) * V + q % V, ok ? 16 : 0);
  }
}

// acc[r][c] = sum_k own[ty + 16 r][k] * other[tx + 16 c][k], k in order, one
// fma a step: the same bits whichever side is `own`.
__device__ __forceinline__ void tile_dot(const float* own, const float* other, int ty, int tx,
                                         float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < CH; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(own + (ty + 16 * r) * LD + k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(other + (tx + 16 * c) * LD + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = acc[r][c];
        v = fmaf(a[r].x, b[c].x, v);
        v = fmaf(a[r].y, b[c].y, v);
        v = fmaf(a[r].z, b[c].z, v);
        v = fmaf(a[r].w, b[c].w, v);
        acc[r][c] = v;
      }
  }
}

// squared point distance by direct difference, each operation rounded on its own
__device__ __forceinline__ float pc_sq(float4 a, float4 p) {
  float dx = __fsub_rn(a.x, p.x), dy = __fsub_rn(a.y, p.y), dz = __fsub_rn(a.z, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

struct Entry {
  float sq, df;       // squared descriptor distance (unclamped), dist_feat
  bool in_radius, positive;
};

// a = (x, y, z, |anc|^2), p = (x, y, z, |pos|^2); identical bits in every pass
__device__ __forceinline__ Entry entry(float dot, float4 a, float dmin, float4 p, float thres_sq) {
  Entry e;
  float x = pc_sq(a, p);
  e.in_radius = x < thres_sq;
  if (dmin == 0.f)
    e.positive = x == 0.f;
  else
    e.positive = __fsqrt_rn(x) == dmin;
  e.sq = __fadd_rn(__fadd_rn(__fmul_rn(-2.f, dot), a.w), p.w);
  e.df = __fsqrt_rn(__fadd_rn(fmaxf(e.sq, 0.f), EPS));
  return e;
}

// the split's column tiles [t0, t1) of `tiles`
__device__ __forceinline__ void split_range(int split, int per_split, int tiles, int& t0, int& t1) {
  t0 = split * per_split;
  t1 = min(t0 + per_split, tiles);
}

// ---------------------------------------------------------------- prep

// aux (x, y, z, |f|^2) of every anchor and positive; minx = +inf, flags = 0.
// The squared norms come from the wrapper, summed as the plain version sums
// them, so that both compute the same distances to the last bit wherever
// their products agree.
__global__ void prep_kernel(const float* __restrict__ asq, const float* __restrict__ psq,
                            const float* __restrict__ apc, const float* __restrict__ ppc,
                            float4* __restrict__ aaux, float4* __restrict__ paux,
                            unsigned* __restrict__ minx, unsigned* __restrict__ flags,
                            int na, int np) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= na + np) return;
  bool anc = idx < na;
  int q = anc ? idx : idx - na;
  const float* pc = (anc ? apc : ppc) + static_cast<size_t>(q) * 3;
  float4 v = make_float4(pc[0], pc[1], pc[2], (anc ? asq : psq)[q]);
  if (anc) {
    aaux[q] = v;
    minx[q] = __float_as_uint(INFINITY);
    flags[q] = 0u;
  } else {
    paux[q] = v;
  }
}

// ---------------------------------------------------------------- pass 1

__global__ void __launch_bounds__(THREADS)
pass1_kernel(const float4* __restrict__ aaux, const float4* __restrict__ paux,
             unsigned* __restrict__ minx, unsigned* __restrict__ flags,
             int n1, int n2, int splits, int per_split, float thres_sq) {
  __shared__ float4 pt[TILE];
  const int b = blockIdx.y;
  const int own_tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = own_tile * TILE;
  aaux += static_cast<size_t>(b) * n1;
  paux += static_cast<size_t>(b) * n2;
  float4 a[4];
  float mn[4];
  unsigned fl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int i = row0 + ty + 16 * r;
    a[r] = aaux[i < n1 ? i : 0];
    mn[r] = INFINITY;
    fl[r] = 0u;
  }
  int t0, t1;
  split_range(split, per_split, (n2 + TILE - 1) / TILE, t0, t1);
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * TILE;
    if (threadIdx.x < TILE) {
      int j = col0 + threadIdx.x;
      pt[threadIdx.x] = paux[j < n2 ? j : 0];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (col0 + tx + 16 * c >= n2) continue;
      float4 p = pt[tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = pc_sq(a[r], p);
        mn[r] = fminf(mn[r], x);
        fl[r] |= x < thres_sq ? IN_RADIUS : OUT_OF_RADIUS;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      mn[r] = fminf(mn[r], __shfl_xor_sync(FULL, mn[r], off));
      fl[r] |= __shfl_xor_sync(FULL, fl[r], off);
    }
    int i = row0 + ty + 16 * r;
    if (tx == 0 && i < n1) {
      // non-negative floats order as their bit patterns: an exact minimum
      atomicMin(minx + static_cast<size_t>(b) * n1 + i, __float_as_uint(mn[r]));
      atomicOr(flags + static_cast<size_t>(b) * n1 + i, fl[r]);
    }
  }
}

__device__ __forceinline__ float row_dmin(unsigned minx, unsigned flags) {
  return (flags & OUT_OF_RADIUS) ? 0.f : __fsqrt_rn(__uint_as_float(minx));
}

// ---------------------------------------------------------------- forward

struct ForwardSmem {
  float own[TILE * LD];
  float other[2][TILE * LD];
  float4 own_aux[TILE];
  float4 other_aux[2][TILE];
  float own_dmin[TILE];
  float colbuf[THREADS / 32][TILE];
};

// Row partials of a split: rowf[(f * splits + split) * B * n1 + b * n1 + i],
// f = 0 the lse_p reference max, 1 furthest, 2 its ties, 3 closest, 4 its
// ties; rowd[(f * splits + split) * ...], f = 0 sum exp(tp - max), 1 sum
// exp(tn - shift). colpart[(b * own_tiles + own_tile) * n2 + j]: the column's
// sum of exp(tn - shift) over the block's rows.
__global__ void __launch_bounds__(THREADS, 2)
forward_kernel(const float* __restrict__ a, const float* __restrict__ p,
               const float4* __restrict__ aaux, const float4* __restrict__ paux,
               const unsigned* __restrict__ minx, const unsigned* __restrict__ flags,
               float* __restrict__ rowf, double* __restrict__ rowd, float* __restrict__ colpart,
               int batch, int n1, int n2, int splits, int per_split, Loss L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ForwardSmem& sm = *reinterpret_cast<ForwardSmem*>(smem_raw);
  const int b = blockIdx.y;
  const int own_tiles = (n1 + TILE - 1) / TILE;
  const int own_tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = own_tile * TILE;
  a += static_cast<size_t>(b) * n1 * CH;
  p += static_cast<size_t>(b) * n2 * CH;
  aaux += static_cast<size_t>(b) * n1;
  paux += static_cast<size_t>(b) * n2;
  minx += static_cast<size_t>(b) * n1;
  flags += static_cast<size_t>(b) * n1;

  int t0, t1;
  split_range(split, per_split, (n2 + TILE - 1) / TILE, t0, t1);
  load_feat(sm.own, a, row0, n1);
  load_vecs<1>(sm.own_aux, aaux, row0, n1);
  load_feat(sm.other[0], p, t0 * TILE, n2);
  load_vecs<1>(sm.other_aux[0], paux, t0 * TILE, n2);
  cp_async_commit();
  if (threadIdx.x < TILE) {
    int i = min(row0 + static_cast<int>(threadIdx.x), n1 - 1);
    sm.own_dmin[threadIdx.x] = row_dmin(minx[i], flags[i]);
  }

  const float s = L.log_scale, mp = L.pos_margin, mn = L.neg_margin, K = L.shift;
  const float eK = expf(-K);           // what an entry with a zero negative term adds
  float Mp[4], F[4], Fn[4], Cl[4], Cn[4];
  double Sp[4], Sn[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    Mp[r] = 0.f; Sp[r] = 0.0; Sn[r] = 0.0;
    F[r] = 0.f; Fn[r] = 0.f; Cl[r] = INFINITY; Cn[r] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t1) {
      load_feat(sm.other[buf ^ 1], p, (t + 1) * TILE, n2);
      load_vecs<1>(sm.other_aux[buf ^ 1], paux, (t + 1) * TILE, n2);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int col0 = t * TILE;
    float acc[4][4];
    tile_dot(sm.own, sm.other[buf], ty, tx, acc);

    float4 pa[4];
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pa[c] = sm.other_aux[buf][tx + 16 * c];
      ok[c] = col0 + tx + 16 * c < n2;
    }
    float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 aa = sm.own_aux[ty + 16 * r];
      const float dmin = sm.own_dmin[ty + 16 * r];
      const bool rok = row0 + ty + 16 * r < n1;
      float tp[4], en[4];
      float m = Mp[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Entry e = entry(acc[r][c], aa, dmin, pa[c], L.thres_sq);
        bool neg = !(e.positive || e.in_radius);
        float term = 0.f, ex = eK;
        if (!neg) {
          float u = __fsub_rn(e.df, mp);
          term = __fmul_rn(__fmul_rn(s, u), fmaxf(u, 0.f));
        } else {
          float v = __fsub_rn(mn, e.df);
          float w = fmaxf(v, 0.f);
          if (w > 0.f) ex = expf(__fsub_rn(__fmul_rn(__fmul_rn(s, v), w), K));
        }
        tp[c] = term;
        en[c] = ok[c] ? ex : 0.f;
        if (rok) colsum[c] += en[c];
        if (ok[c]) {
          m = fmaxf(m, term);
          if (e.positive) {
            if (e.df > F[r]) { F[r] = e.df; Fn[r] = 1.f; }
            else if (e.df == F[r]) Fn[r] += 1.f;
          }
          float cv = e.positive ? __fadd_rn(e.df, BIG) : e.df;
          if (cv < Cl[r]) { Cl[r] = cv; Cn[r] = 1.f; }
          else if (cv == Cl[r]) Cn[r] += 1.f;
        }
      }
      if (m > Mp[r]) {
        Sp[r] *= static_cast<double>(expf(Mp[r] - m));
        Mp[r] = m;
      }
      const float z = expf(-Mp[r]);
      float s4 = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (ok[c]) s4 += tp[c] == 0.f ? z : expf(tp[c] - Mp[r]);
      Sp[r] += static_cast<double>(s4);
      Sn[r] += static_cast<double>((en[0] + en[1]) + (en[2] + en[3]));
    }
    // the columns' sums over the block's 64 rows, a fixed tree
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = colsum[c] + __shfl_xor_sync(FULL, colsum[c], 16);
      if (lane < 16) sm.colbuf[warp][tx + 16 * c] = v;
    }
    __syncthreads();
    if (threadIdx.x < TILE) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) v += sm.colbuf[w][threadIdx.x];
      int j = col0 + threadIdx.x;
      if (j < n2) colpart[(static_cast<size_t>(b) * own_tiles + own_tile) * n2 + j] = v;
    }
    __syncthreads();
  }

  const size_t plane = static_cast<size_t>(batch) * n1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float M = Mp[r], f = F[r], fn = Fn[r], cl = Cl[r], cn = Cn[r];
    double S = Sp[r], N = Sn[r];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      float Mo = __shfl_xor_sync(FULL, M, off);
      double So = __shfl_xor_sync(FULL, S, off);
      float Mx = fmaxf(M, Mo);
      S = S * static_cast<double>(expf(M - Mx)) + So * static_cast<double>(expf(Mo - Mx));
      M = Mx;
      N += __shfl_xor_sync(FULL, N, off);
      float fo = __shfl_xor_sync(FULL, f, off), fno = __shfl_xor_sync(FULL, fn, off);
      if (fo > f) { f = fo; fn = fno; } else if (fo == f) fn += fno;
      float co = __shfl_xor_sync(FULL, cl, off), cno = __shfl_xor_sync(FULL, cn, off);
      if (co < cl) { cl = co; cn = cno; } else if (co == cl) cn += cno;
    }
    int i = row0 + ty + 16 * r;
    if (tx == 0 && i < n1) {
      size_t at = static_cast<size_t>(split) * plane + static_cast<size_t>(b) * n1 + i;
      size_t fs = static_cast<size_t>(splits) * plane;
      rowf[at] = M;
      rowf[fs + at] = f;
      rowf[2 * fs + at] = fn;
      rowf[3 * fs + at] = cl;
      rowf[4 * fs + at] = cn;
      rowd[at] = S;
      rowd[fs + at] = N;
    }
  }
}

// ---------------------------------------------------------------- merge

// rows: the splits in order; columns: the row blocks in order.
__global__ void merge_kernel(const float* __restrict__ rowf, const double* __restrict__ rowd,
                             const float* __restrict__ colpart, const unsigned* __restrict__ minx,
                             const unsigned* __restrict__ flags, float* __restrict__ lse_p,
                             float* __restrict__ lse_n, float* __restrict__ fur,
                             float* __restrict__ fur_n, float* __restrict__ clo,
                             float* __restrict__ clo_n, float* __restrict__ dmin,
                             unsigned char* __restrict__ has, float* __restrict__ lse_col,
                             int batch, int n1, int n2, int splits, float shift) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = static_cast<size_t>(batch) * n1;
  if (idx < static_cast<int>(plane)) {
    const size_t fs = static_cast<size_t>(splits) * plane;
    float M = -INFINITY;
    for (int k = 0; k < splits; ++k) M = fmaxf(M, rowf[k * plane + idx]);
    double S = 0.0, N = 0.0;
    float f = 0.f, fn = 0.f, cl = INFINITY, cn = 0.f;
    for (int k = 0; k < splits; ++k) {
      size_t at = k * plane + idx;
      S += rowd[at] * exp(static_cast<double>(rowf[at]) - static_cast<double>(M));
      N += rowd[fs + at];
      float fo = rowf[fs + at], fno = rowf[2 * fs + at];
      if (fo > f) { f = fo; fn = fno; } else if (fo == f) fn += fno;
      float co = rowf[3 * fs + at], cno = rowf[4 * fs + at];
      if (co < cl) { cl = co; cn = cno; } else if (co == cl) cn += cno;
    }
    lse_p[idx] = static_cast<float>(static_cast<double>(M) + log(S));
    lse_n[idx] = static_cast<float>(static_cast<double>(shift) + log(N));
    fur[idx] = f;
    fur_n[idx] = fn;
    clo[idx] = cl;
    clo_n[idx] = cn;
    dmin[idx] = row_dmin(minx[idx], flags[idx]);
    has[idx] = (flags[idx] & IN_RADIUS) ? 1 : 0;
    return;
  }
  idx -= static_cast<int>(plane);
  if (idx >= batch * n2) return;
  const int b = idx / n2, j = idx % n2;
  const int own_tiles = (n1 + TILE - 1) / TILE;
  double S = 0.0;
  for (int t = 0; t < own_tiles; ++t)
    S += static_cast<double>(colpart[(static_cast<size_t>(b) * own_tiles + t) * n2 + j]);
  lse_col[idx] = static_cast<float>(static_cast<double>(shift) + log(S));
}

// ---------------------------------------------------------------- backward

// anchor side, 3 float4 a point: (x, y, z, |a|^2), (dmin, lse_p, cp, cn),
// (furthest, cf, closest, ccl), with cp = s g_p, cn = s g_n exp(shift - lse_n),
// cf = g_f / ties, ccl = g_c / ties; positive side, 2 float4 a point:
// (x, y, z, |p|^2), (ccol, 0, 0, 0) with ccol = s g_col exp(shift - lse_col).
constexpr int AV = 3, PV = 2;

__global__ void backward_prep_kernel(const float4* __restrict__ aaux, const float4* __restrict__ paux,
                                     const float* __restrict__ dmin, const float* __restrict__ lse_p,
                                     const float* __restrict__ lse_n, const float* __restrict__ fur,
                                     const float* __restrict__ fur_n, const float* __restrict__ clo,
                                     const float* __restrict__ clo_n, const float* __restrict__ lse_col,
                                     const float* __restrict__ g_p, const float* __restrict__ g_n,
                                     const float* __restrict__ g_f, const float* __restrict__ g_c,
                                     const float* __restrict__ g_col, float4* __restrict__ aside,
                                     float4* __restrict__ pside, int na, int np, float log_scale,
                                     float shift) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < na) {
    float cn = log_scale * g_n[idx] * expf(shift - lse_n[idx]);
    aside[idx * AV] = aaux[idx];
    aside[idx * AV + 1] = make_float4(dmin[idx], lse_p[idx], log_scale * g_p[idx], cn);
    aside[idx * AV + 2] = make_float4(fur[idx], g_f[idx] / fmaxf(fur_n[idx], 1.f), clo[idx],
                                      g_c[idx] / fmaxf(clo_n[idx], 1.f));
    return;
  }
  idx -= na;
  if (idx >= np) return;
  pside[idx * PV] = paux[idx];
  pside[idx * PV + 1] =
      make_float4(log_scale * g_col[idx] * expf(shift - lse_col[idx]), 0.f, 0.f, 0.f);
}

// the coefficient on dist_feat of entry (i, j), times d dist_feat / d sq
__device__ __forceinline__ float entry_grad(float dot, const float4* av, const float4& pxyz,
                                            float ccol, const Loss& L) {
  const float4 geo = av[0], st = av[1], det = av[2];
  Entry e = entry(dot, geo, st.x, pxyz, L.thres_sq);
  bool neg = !(e.positive || e.in_radius);
  float g = 0.f;
  if (!neg) {
    float u = __fsub_rn(e.df, L.pos_margin);
    float w = fmaxf(u, 0.f);
    if (w > 0.f) {
      float term = __fmul_rn(__fmul_rn(L.log_scale, u), w);
      g = st.z * expf(__fsub_rn(term, st.y)) * w;
    }
  } else {
    float v = __fsub_rn(L.neg_margin, e.df);
    float w = fmaxf(v, 0.f);
    if (w > 0.f) {
      float term = __fmul_rn(__fmul_rn(L.log_scale, v), w);
      g = -(expf(__fsub_rn(term, L.shift)) * w) * (st.w + ccol);
    }
  }
  if (e.positive && e.df == det.x) g += det.y;
  float cv = e.positive ? __fadd_rn(e.df, BIG) : e.df;
  if (cv == det.z) g += det.w;
  if (g == 0.f || e.sq < 0.f) return 0.f;
  return __fdiv_rn(g, __fmul_rn(2.f, e.df));
}

// e_ij = -2 g'_ij of the anchors [0, n1) against the positives
// [c0, c0 + width): out[(b * n1 + i) * width + j - c0], one 64 x 64 block of
// entries a block; beside it each block's sums of e over its 64 columns,
// rowpart[(b * n1 + i) * part_cols + part_col0 + blockIdx.x], and over its
// 64 rows, colpart[(b * ceil(n1 / 64) + blockIdx.y) * n2 + j]. The distances
// are the forward's to the last bit (the same products in the same order),
// so the detector's max and min entries are found again.
__global__ void __launch_bounds__(THREADS)
grad_tile_kernel(const float* __restrict__ a, const float* __restrict__ p,
                 const float4* __restrict__ aside, const float4* __restrict__ pside,
                 float* __restrict__ out, float* __restrict__ rowpart,
                 float* __restrict__ colpart, int n1, int n2, int c0, int width, int part_col0,
                 int part_cols, Loss L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* anc = reinterpret_cast<float*>(smem_raw);
  float* pos = anc + TILE * LD;
  float4* anc_v = reinterpret_cast<float4*>(pos + TILE * LD);
  float4* pos_v = anc_v + TILE * AV;
  float* colbuf = reinterpret_cast<float*>(pos_v + TILE * PV);     // [THREADS / 32][TILE]
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.y * TILE;
  const int col0 = c0 + blockIdx.x * TILE;            // a global positive index
  const int col_end = min(c0 + width, n2);
  load_feat(anc, a + static_cast<size_t>(b) * n1 * CH, row0, n1);
  load_vecs<AV>(anc_v, aside + static_cast<size_t>(b) * n1 * AV, row0, n1);
  load_feat(pos, p + static_cast<size_t>(b) * n2 * CH, col0, col_end);
  load_vecs<PV>(pos_v, pside + static_cast<size_t>(b) * n2 * PV, col0, col_end);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[4][4];
  tile_dot(anc, pos, ty, tx, acc);
  float* o = out + static_cast<size_t>(b) * n1 * width;
  float csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + ty + 16 * r;
    const float4* av = anc_v + (ty + 16 * r) * AV;
    float4 avr[3] = {av[0], av[1], av[2]};
    float rsum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = col0 + tx + 16 * c;
      if (i >= n1 || j >= col_end) continue;
      const float4* pv = pos_v + (tx + 16 * c) * PV;
      const float e = -2.f * entry_grad(acc[r][c], avr, pv[0], pv[1].x, L);
      o[static_cast<size_t>(i) * width + (j - c0)] = e;
      rsum += e;
      csum[c] += e;
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) rsum += __shfl_xor_sync(FULL, rsum, off);
    if (tx == 0 && i < n1)
      rowpart[(static_cast<size_t>(b) * n1 + i) * part_cols + part_col0 + blockIdx.x] = rsum;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float v = csum[c] + __shfl_xor_sync(FULL, csum[c], 16);
    if (lane < 16) colbuf[warp * TILE + tx + 16 * c] = v;
  }
  __syncthreads();
  if (threadIdx.x < TILE && col0 + static_cast<int>(threadIdx.x) < col_end) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) v += colbuf[w * TILE + threadIdx.x];
    colpart[(static_cast<size_t>(b) * gridDim.y + blockIdx.y) * n2 + col0 + threadIdx.x] = v;
  }
}

int grid_1d(long long n) { return static_cast<int>((n + 255) / 256); }

}  // namespace

// a (batch, n1, 64), p (batch, n2, 64), asq (batch, n1), psq (batch, n2) their
// squared norms, apc (batch, n1, 3), ppc (batch, n2, 3) f32 contiguous. Scratch: aaux (batch, n1, 4), paux (batch, n2, 4), minx and
// flags (batch, n1) u32, rowf (5, splits, batch, n1) f32, rowd (2, splits,
// batch, n1) f64, colpart (batch, ceil(n1 / 64), n2) f32. Outputs (batch, n1):
// lse_p, lse_n, furthest, its ties, closest, its ties, dist_min (f32), has_pos
// (u8); (batch, n2): lse_col. `splits` divides pass 1's and the forward's
// sweep over positives into `splits` shares of `per_split` column tiles.
// Four operations on `stream`; returns the first non-zero CUDA error code, or 0.
extern "C" int circle_forward_launch(const float* a, const float* p, const float* asq,
                                     const float* psq, const float* apc, const float* ppc, float* aaux, float* paux, unsigned* minx,
                                     unsigned* flags, float* rowf, double* rowd, float* colpart,
                                     float* lse_p, float* lse_n, float* fur, float* fur_n,
                                     float* clo, float* clo_n, float* dmin, unsigned char* has,
                                     float* lse_col, int batch, int n1, int n2, int splits,
                                     int per_split, float thres_sq, float log_scale,
                                     float pos_margin, float neg_margin, float shift,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Loss L{thres_sq, log_scale, pos_margin, neg_margin, shift};
  const long long na = static_cast<long long>(batch) * n1, np = static_cast<long long>(batch) * n2;
  prep_kernel<<<grid_1d(na + np), 256, 0, st>>>(asq, psq, apc, ppc, reinterpret_cast<float4*>(aaux),
                                                 reinterpret_cast<float4*>(paux), minx, flags,
                                                 static_cast<int>(na), static_cast<int>(np));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int own_tiles = (n1 + TILE - 1) / TILE;
  dim3 grid(own_tiles * splits, batch);
  pass1_kernel<<<grid, THREADS, 0, st>>>(reinterpret_cast<const float4*>(aaux),
                                         reinterpret_cast<const float4*>(paux), minx, flags, n1,
                                         n2, splits, per_split, thres_sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(sizeof(ForwardSmem));
  err = cudaFuncSetAttribute(forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  forward_kernel<<<grid, THREADS, smem, st>>>(a, p, reinterpret_cast<const float4*>(aaux),
                                              reinterpret_cast<const float4*>(paux), minx, flags,
                                              rowf, rowd, colpart, batch, n1, n2, splits,
                                              per_split, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<grid_1d(na + np), 256, 0, st>>>(rowf, rowd, colpart, minx, flags, lse_p, lse_n,
                                                 fur, fur_n, clo, clo_n, dmin, has, lse_col,
                                                 batch, n1, n2, splits, shift);
  return static_cast<int>(cudaGetLastError());
}

// The backward of circle_forward_launch, in two calls. circle_backward_prep:
// g_p, g_n, g_f, g_c (batch, n1) and g_col (batch, n2), the gradients of
// lse_p, lse_n, furthest, closest and lse_col, with the forward's saved rows
// into aside (batch, n1, 12) and pside (batch, n2, 8) f32. One operation on
// `stream`; returns the CUDA error code, or 0.
extern "C" int circle_backward_prep(const float* aaux, const float* paux, const float* dmin,
                                    const float* lse_p, const float* lse_n, const float* fur,
                                    const float* fur_n, const float* clo, const float* clo_n,
                                    const float* lse_col, const float* g_p, const float* g_n,
                                    const float* g_f, const float* g_c, const float* g_col,
                                    float* aside, float* pside, int batch, int n1, int n2,
                                    float log_scale, float shift, void* stream) {
  const long long na = static_cast<long long>(batch) * n1, np = static_cast<long long>(batch) * n2;
  backward_prep_kernel<<<grid_1d(na + np), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(aaux), reinterpret_cast<const float4*>(paux), dmin, lse_p,
      lse_n, fur, fur_n, clo, clo_n, lse_col, g_p, g_n, g_f, g_c, g_col,
      reinterpret_cast<float4*>(aside), reinterpret_cast<float4*>(pside), static_cast<int>(na),
      static_cast<int>(np), log_scale, shift);
  return static_cast<int>(cudaGetLastError());
}

// circle_grad_tile: -2 d loss / d sq of every anchor against the positives
// [c0, c0 + width), sq the squared descriptor distance, into out (batch, n1,
// width) f32; a (batch, n1, 64), p (batch, n2, 64) as in the forward. Its
// sums: over each block of 64 columns into rowpart (batch, n1, part_cols) at
// part_col0 + the block's index in the tile; over each block of 64 rows into
// colpart (batch, ceil(n1 / 64), n2). One operation on `stream`; returns the
// CUDA error code, or 0.
extern "C" int circle_grad_tile(const float* a, const float* p, const float* aside,
                                const float* pside, float* out, float* rowpart, float* colpart,
                                int batch, int n1, int n2, int c0, int width, int part_col0,
                                int part_cols, float thres_sq, float log_scale, float pos_margin,
                                float neg_margin, float shift, void* stream) {
  Loss L{thres_sq, log_scale, pos_margin, neg_margin, shift};
  const int smem = 2 * TILE * LD * static_cast<int>(sizeof(float)) + TILE * (AV + PV) * 16 +
                   THREADS / 32 * TILE * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(grad_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((width + TILE - 1) / TILE, (n1 + TILE - 1) / TILE, batch);
  grad_tile_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, p, reinterpret_cast<const float4*>(aside), reinterpret_cast<const float4*>(pside), out,
      rowpart, colpart, n1, n2, c0, width, part_col0, part_cols, L);
  return static_cast<int>(cudaGetLastError());
}
