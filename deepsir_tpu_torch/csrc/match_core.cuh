// The descriptor-match core shared by K2 (match_argmin.cu) and K3
// (match_bidir.cu): the (N, C) x (C, M) products of every src row with every
// ref row on Hopper's tensor cores, reduced as they come out of the
// accumulators into a row argmin (and, for K3, a column argmin), never
// materialising the (N, M) distance matrix.
//
// Two operand forms, chosen by a template parameter:
// - Form::Fp32x3 (the default, fp32-grade). Every fp32 operand x is split into
//   big = rna_tf32(x) and small = rna_tf32(x - big), and each fragment step
//   issues three `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`
//   (small.big, big.small, big.big) into fp32 accumulators. The dropped
//   small.small term is below 2^-22 of the product, so the sums carry the
//   same ~1e-7 relative error as an fp32 dot product; one TF32 product alone
//   carries ~1e-3 and breaks the near-tie rule. rna_tf32 is
//   `cvt.rna.tf32.f32` (round to nearest, ties away from zero, low 13 bits
//   cleared) written as two integer operations on the bits; it gives the
//   same value for every finite input.
// - Form::Bf16 (`low_precision`, as the TPU kernel's bf16 operands): each
//   operand is rounded to bf16 (round to nearest even), and each step issues
//   one `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`. bf16 products
//   are exact in fp32, so this is the fp32 search of the bf16-rounded
//   operands; the norms stay those of the fp32 inputs.
// The precision is fixed here, inside the kernel; the process-wide torch
// flags that keep TF32 off for torch's own matmuls do not reach it.
//
// Tiles. A block of 8 warps owns 128 src rows and walks a range of ref tiles
// of 64 rows; warps sit 4 (rows) x 2 (columns), each computing a 32 x 32
// tile as 2 x 4 fragments of m16n8. The src tile is staged once (C <= 128
// fits whole); ref tiles and their |r|^2 stream through a ring of 3
// shared-memory stages filled by `cp.async` (16-byte `.cg` copies, 4-byte
// ones when C % 4 != 0), so the next two tiles' copies run under the current
// tile's MMAs. Channels are zero-padded in shared memory to a multiple of 16
// (zeros add nothing to a dot product) by the copies' zero fill. Each thread
// reads its fragment values as one 16-byte load per row and 16-channel
// chunk: within a chunk, thread t of a quad takes channels 4t..4t+3 and maps
// them onto the MMA's k slots (a permutation of k, the same for both
// operands, so the sum is the same). Rows are 16 floats (mod 32) apart, so
// each 8-lane phase of such a load touches 32 distinct banks: the fragment
// loads are free of bank conflicts. Operands are split (or converted to
// bf16) in registers as their fragments are loaded. Splitting each ref tile
// once when it lands (big halves in place, small halves beside them, a
// 2-stage ring to make room) was tried and ran slower on the H100, in both
// forms: the extra barrier per tile and the shallower ring cost more than
// the 4x redundant splitting by the row warps saves. Each accumulator takes
// its three products in the order small.big, big.small, big.big.
//
// Epilogue, in the accumulator layout (thread holds rows g, g+8 and columns
// 2t, 2t+1 of each fragment): the accumulators become d = |r|^2 - 2 s.r in
// place; per row the tile's minimum is taken first and, only where it beats
// the running minimum (a strict compare; tiles ascend), the lowest column
// that reaches it, so the lowest index wins among ties. K3 also forms
// d + |s|^2 per column, takes the minimum over the thread's rows (ascending,
// strict), then over the warp's 8 row groups by shuffles, and stores one key
// per column and row warp in shared memory; after the next tile's barrier
// (the key buffers alternate) 64 threads merge the 4 row warps' keys and
// issue one 64-bit atomicMin per column per block. Columns past M and rows
// past N never compete.
//
// Filling the card. At N = M = 18000, B = 1 there are only 141 row blocks,
// about one per SM (2 fit on each). So the ref sweep is split across blocks:
// the launcher picks the tiles per block from the SM count and the blocks
// per SM that the occupancy API reports, minimising waves x (tiles per
// block + 1); at B = 1 that is 22 tiles per block, 13 splits, 1833 blocks,
// 6.9 waves of 264 (B = 2: 3666 blocks, 13.9 waves). Every block merges its row results with a 64-bit atomicMin of
// (orderable(d) << 32) | column into a key array filled with ones; K3's
// columns merge the same way with (orderable(d + |s|^2) << 32) | row. The
// minimum of such keys does not depend on the order of the atomics, so the
// result is deterministic and ties go to the lowest index. A last small
// kernel keeps each key's low word.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>
#include <mutex>

namespace match_core {

enum class Form { Fp32x3, Bf16 };

constexpr int kBM = 128;                        // src rows per block
constexpr int kBN = 64;                         // ref rows per tile
constexpr int kStages = 3;                      // ref tiles in flight
constexpr int kWarpsM = 4, kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;              // 32 rows per warp
constexpr int kWN = kBN / kWarpsN;              // 32 columns per warp
constexpr int kMT = kWM / 16;                   // m16 fragments per warp
constexpr int kNT = kWN / 8;                    // n8 fragments per warp
constexpr int kKC = 16;                         // channels per fragment chunk
constexpr int kMaxChannels = 128;

typedef unsigned long long u64;

// channels padded to whole chunks, and the shared-memory row stride in
// floats: 16 (mod 32), so 16-byte fragment loads are free of bank conflicts
__host__ __device__ inline int padded_channels(int c) { return (c + kKC - 1) / kKC * kKC; }
__host__ __device__ inline int row_stride(int c) {
  const int cp = padded_channels(c);
  return cp % 32 == 0 ? cp + 16 : cp;
}
inline size_t smem_bytes(int c, bool bidir) {
  return sizeof(float) * ((size_t)(kBM + kStages * kBN) * row_stride(c) + kStages * kBN) +
         (bidir ? sizeof(u64) * 2 * kWarpsM * kBN : 0);
}

// fp32 -> uint32 with the same order (for non-NaN values); -0 folds into +0
__device__ __forceinline__ unsigned int orderable_bits(float f) {
  const unsigned int u = __float_as_uint(__fadd_rn(f, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float d, int i) {
  return i == INT_MAX ? ~0ull : ((u64)orderable_bits(d) << 32) | (unsigned int)i;
}

__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }

// cvt.rna.tf32.f32: round the magnitude to 10 mantissa bits, ties away from
// zero, by adding half of the last kept bit and clearing the 13 below it
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  const float b = rna_tf32(x);
  big = __float_as_uint(b);
  small = __float_as_uint(rna_tf32(x - b));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start the copy of rows [r0, r0 + rows) of g (total rows, c channels each)
// into sm (stride s floats, cp padded channels); rows past `total` and
// channels past c are zero-filled.
template <bool kVec16>
__device__ __forceinline__ void load_rows(float* sm, const float* g, int r0, int rows,
                                          int total, int c, int cp, int s) {
  const int per_row = kVec16 ? cp / 4 : cp;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row;
    const int k = (e - r * per_row) * (kVec16 ? 4 : 1);
    const bool ok = r0 + r < total && k < c;
    const float* src = ok ? g + (size_t)(r0 + r) * c + k : g;
    if (kVec16)
      cp_async16(sm + r * s + k, src, ok);
    else
      cp_async4(sm + r * s + k, src, ok);
  }
}

// One 16-channel chunk of the warp's 32 x 32 tile. a[mt][h]: channels
// 4t..4t+3 of row g + 8h of fragment mt; b[nt]: the same of ref row g of
// fragment nt.
template <Form F>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMT][kNT][4],
                                          const float4 (&a)[kMT][2],
                                          const float4 (&b)[kNT]) {
  if constexpr (F == Form::Fp32x3) {
    // k step ks takes channels 4t + 2ks (k slot t) and 4t + 2ks + 1 (slot t+4)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      unsigned ab[kMT][4], as[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        split_tf32(ks ? a[mt][0].z : a[mt][0].x, ab[mt][0], as[mt][0]);
        split_tf32(ks ? a[mt][1].z : a[mt][1].x, ab[mt][1], as[mt][1]);
        split_tf32(ks ? a[mt][0].w : a[mt][0].y, ab[mt][2], as[mt][2]);
        split_tf32(ks ? a[mt][1].w : a[mt][1].y, ab[mt][3], as[mt][3]);
      }
      unsigned bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        split_tf32(ks ? b[nt].z : b[nt].x, bb[nt][0], bs[nt][0]);
        split_tf32(ks ? b[nt].w : b[nt].y, bb[nt][1], bs[nt][1]);
      }
      // each accumulator takes small.big, big.small, big.big in that order;
      // the 8 fragments' products interleave between dependent MMAs
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], as[mt], bb[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
    }
  } else {
    // channels 4t, 4t+1 take k slots 2t, 2t+1; 4t+2, 4t+3 take 2t+8, 2t+9
    unsigned af[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      af[mt][0] = pack_bf16(a[mt][0].x, a[mt][0].y);
      af[mt][1] = pack_bf16(a[mt][1].x, a[mt][1].y);
      af[mt][2] = pack_bf16(a[mt][0].z, a[mt][0].w);
      af[mt][3] = pack_bf16(a[mt][1].z, a[mt][1].w);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const unsigned bf[2] = {pack_bf16(b[nt].x, b[nt].y), pack_bf16(b[nt].z, b[nt].w)};
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt][nt], af[mt], bf);
    }
  }
}

// Grid (row blocks, ref splits, batch). Every block sweeps ref tiles
// [split * tiles, min(split * tiles + tiles, ceil(m / kBN))) for its kBM src
// rows and merges into row_key (batch, n) and, with kBidir, col_key
// (batch, m), both filled with all ones beforehand.
template <Form F, bool kBidir, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2)
match_kernel(const float* __restrict__ src, const float* __restrict__ ref,
             const float* __restrict__ src_sq, const float* __restrict__ ref_sq,
             u64* __restrict__ row_key, u64* __restrict__ col_key, int n, int m,
             int c, int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int cp = padded_channels(c), s = row_stride(c);
  float* as = smem;                                   // kBM x s
  float* bs = smem + kBM * s;                         // kStages x kBN x s
  float* rsq = bs + kStages * kBN * s;                // kStages x kBN: |r|^2
  u64* ck = reinterpret_cast<u64*>(rsq + kStages * kBN);   // 2 x kWarpsM x kBN

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kBM;
  const int t_begin = blockIdx.y * tiles;
  const int t_end = min((m + kBN - 1) / kBN, t_begin + tiles);
  src += (size_t)b * n * c;
  ref += (size_t)b * m * c;
  ref_sq += (size_t)b * m;
  row_key += (size_t)b * n;
  if (kBidir) {
    src_sq += (size_t)b * n;
    col_key += (size_t)b * m;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = lane >> 2, t = lane & 3;
  const float inf = __int_as_float(0x7f800000);

  // start the copy of ref tile `tl` and its |r|^2 into ring stage `st`
  auto load_tile = [&](int st, int tl) {
    load_rows<kVec16>(bs + st * kBN * s, ref, tl * kBN, kBN, m, c, cp, s);
    const int r = tl * kBN + (int)threadIdx.x;
    if (threadIdx.x < kBN) cp_async4(rsq + st * kBN + threadIdx.x, r < m ? ref_sq + r : ref_sq,
                                     r < m);
  };
  // K3: the block's column minima of tile `tl`, from the 4 row warps' keys
  auto merge_columns = [&](const u64* keys, int tl) {
    const int col = tl * kBN + (int)threadIdx.x;
    if (threadIdx.x < kBN && col < m) {
      u64 key = keys[threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarpsM; ++w) key = kmin(key, keys[w * kBN + threadIdx.x]);
      if (key != ~0ull) atomicMin(col_key + col, key);
    }
  };
  // the src tile and the first two ref tiles
  load_rows<kVec16>(as, src, row0, kBM, n, c, cp, s);
  load_tile(0, t_begin);
  cp_async_commit();
  if (t_begin + 1 < t_end) load_tile(1, t_begin + 1);
  cp_async_commit();

  // this thread's rows: row0 + wm * kWM + mt * 16 + h * 8 + g, ascending in (mt, h)
  float best_d[kMT][2], ss[kMT][2];
  int best_i[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * kWM + mt * 16 + h * 8 + g;
      best_d[mt][h] = inf;
      best_i[mt][h] = INT_MAX;
      ss[mt][h] = kBidir && row < n ? src_sq[row] : inf;
    }

  const float* a_base = as + (wm * kWM + g) * s + 4 * t;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int it = tile - t_begin;
    cp_async_wait<kStages - 2>();       // this thread's copies of `tile` landed
    __syncthreads();                    // everyone's landed; tile - 1 is consumed
    // K3: the previous tile's column keys are complete
    if (kBidir && it > 0) merge_columns(ck + ((it - 1) & 1) * kWarpsM * kBN, tile - 1);
    if (tile + 2 < t_end) load_tile((it + 2) % kStages, tile + 2);
    cp_async_commit();

    const float* b_base = bs + (it % kStages) * kBN * s + (wn * kWN + g) * s + 4 * t;
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int k0 = 0; k0 < cp; k0 += kKC) {
      float4 a[kMT][2], bv[kNT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[mt][h] = *reinterpret_cast<const float4*>(a_base + (mt * 16 + h * 8) * s + k0);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        bv[nt] = *reinterpret_cast<const float4*>(b_base + nt * 8 * s + k0);
      mma_chunk<F>(acc, a, bv);
    }

    // acc[mt][nt][2h + j] becomes the distance of row (mt, h) to column
    // col0 + nt * 8 + j; columns past m get +inf and never compete
    const int col0 = tile * kBN + wn * kWN + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = col0 + nt * 8 + j;
        const float rs = col < m ? rsq[(it % kStages) * kBN + col - tile * kBN] : inf;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            acc[mt][nt][2 * h + j] = rs - 2.f * acc[mt][nt][2 * h + j];
      }
    // rows: the tile's minimum first, and only where it beats the running
    // one the lowest column reaching it; with tiles ascending, a strict
    // compare keeps the lowest index among ties
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmin = acc[mt][0][2 * h];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) tmin = fminf(tmin, acc[mt][nt][2 * h + j]);
        if (tmin < best_d[mt][h]) {
          int first = INT_MAX;
#pragma unroll
          for (int nt = kNT - 1; nt >= 0; --nt)
#pragma unroll
            for (int j = 1; j >= 0; --j)
              if (acc[mt][nt][2 * h + j] == tmin) first = col0 + nt * 8 + j;
          best_d[mt][h] = tmin;
          best_i[mt][h] = first;
        }
      }
    if (kBidir) {
      // columns: d + |s|^2 over the thread's rows (ascending, strict), then
      // over the warp's 8 row groups (lane bits 2-4), ties to the lower row
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float bc = inf;
          int br = INT_MAX;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float dc = acc[mt][nt][2 * h + j] + ss[mt][h];
              if (dc < bc) {
                bc = dc;
                br = row0 + wm * kWM + mt * 16 + h * 8 + g;
              }
            }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const float od = __shfl_xor_sync(0xffffffffu, bc, off);
            const int orow = __shfl_xor_sync(0xffffffffu, br, off);
            if (od < bc || (od == bc && orow < br)) {
              bc = od;
              br = orow;
            }
          }
          if (g == 0)
            ck[(it & 1) * kWarpsM * kBN + wm * kBN + wn * kWN + nt * 8 + 2 * t + j] =
                make_key(bc, br);
        }
      // merged after the next tile's __syncthreads(); the key buffers
      // alternate, so a buffer is rewritten only after that merge
    }
  }
  if (kBidir) {
    __syncthreads();
    merge_columns(ck + ((t_end - 1 - t_begin) & 1) * kWarpsM * kBN, t_end - 1);
  }

  // over the quad (lane bits 0-1), then one atomic per row and column warp
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      u64 key = make_key(best_d[mt][h], best_i[mt][h]);
      key = kmin(key, __shfl_xor_sync(0xffffffffu, key, 1));
      key = kmin(key, __shfl_xor_sync(0xffffffffu, key, 2));
      const int row = row0 + wm * kWM + mt * 16 + h * 8 + g;
      if (t == 0 && row < n && key != ~0ull) atomicMin(row_key + row, key);
    }
}

// keys -> indices, in place; a key never written (no finite candidate) -> 0
__global__ void key_low_words(long long* __restrict__ a, long long na,
                              long long* __restrict__ b, long long nb) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long* p = i < na ? a + i : (i < na + nb ? b + (i - na) : nullptr);
  if (p) {
    const u64 k = (u64)*p;
    *p = k == ~0ull ? 0 : (long long)(k & 0xffffffffull);
  }
}

// Ref tiles per block: the count that minimises waves x (tiles + 1), the
// extra tile standing for the block's src staging and pipeline fill.
inline int tiles_per_block(long long row_blocks, int n_tiles, long long slots) {
  int best = n_tiles;
  long long best_cost = -1;
  for (int tiles = 1; tiles <= n_tiles; ++tiles) {
    const long long splits = (n_tiles + tiles - 1) / tiles;
    const long long waves = (row_blocks * splits + slots - 1) / slots;
    const long long cost = waves * (tiles + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = tiles;
    }
  }
  return best;
}

constexpr int kMaxDevices = 64;

// The kernel's shared-memory limit (set once per device, to what C = 128
// needs) and its resident block slots, SMs x blocks per SM, at each C: asked
// of the runtime at the first call and cached, so that a later call costs
// the host only its launches.
template <Form F, bool kBidir, bool kVec16>
cudaError_t block_slots(int c, int* slots) {
  auto kernel = match_kernel<F, kBidir, kVec16>;
  static std::once_flag once[kMaxDevices];
  static cudaError_t once_err[kMaxDevices];
  static int sms[kMaxDevices];
  static std::atomic<int> cached[kMaxDevices][kMaxChannels + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [&] {
    once_err[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(kMaxChannels, kBidir));
    if (once_err[dev] == cudaSuccess)
      once_err[dev] = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  });
  if (once_err[dev] != cudaSuccess) return once_err[dev];
  int s = cached[dev][c].load(std::memory_order_relaxed);
  if (s == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        smem_bytes(c, kBidir));
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    s = sms[dev] * per_sm;
    cached[dev][c].store(s, std::memory_order_relaxed);
  }
  *slots = s;
  return cudaSuccess;
}

template <Form F, bool kBidir, bool kVec16>
cudaError_t launch_form(const float* src, const float* ref, const float* src_sq,
                        const float* ref_sq, u64* row_key, u64* col_key, int batch,
                        int n, int m, int c, cudaStream_t st) {
  int slots = 0;
  cudaError_t err = block_slots<F, kBidir, kVec16>(c, &slots);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(c, kBidir);
  const int row_blocks = (n + kBM - 1) / kBM;
  const int n_tiles = (m + kBN - 1) / kBN;
  const int tiles = tiles_per_block((long long)row_blocks * batch, n_tiles, slots);
  const dim3 grid(row_blocks, (n_tiles + tiles - 1) / tiles, batch);
  match_kernel<F, kBidir, kVec16><<<grid, kThreads, smem, st>>>(
      src, ref, src_sq, ref_sq, row_key, col_key, n, m, c, tiles);
  return cudaGetLastError();
}

// src (batch, n, c), ref (batch, m, c), src_sq (batch, n; K3 only), ref_sq
// (batch, m) f32 contiguous; writes idx (batch, n) and, with kBidir, ridx
// (batch, m) int64. Fill, search, keys -> indices, all on `st`.
template <bool kBidir>
int launch(const float* src, const float* ref, const float* src_sq, const float* ref_sq,
           long long* idx, long long* ridx, int batch, int n, int m, int c,
           int low_precision, void* stream) {
  if (c < 1 || c > kMaxChannels || n < 1 || m < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)batch * n, n_cols = kBidir ? (long long)batch * m : 0;
  cudaError_t err = cudaMemsetAsync(idx, 0xff, sizeof(long long) * n_rows, st);
  if (err == cudaSuccess && kBidir)
    err = cudaMemsetAsync(ridx, 0xff, sizeof(long long) * n_cols, st);
  if (err != cudaSuccess) return (int)err;
  const bool vec16 = c % 4 == 0 && ((uintptr_t)src | (uintptr_t)ref) % 16 == 0;
  u64* rk = reinterpret_cast<u64*>(idx);
  u64* ck = reinterpret_cast<u64*>(ridx);
  if (low_precision)
    err = vec16 ? launch_form<Form::Bf16, kBidir, true>(src, ref, src_sq, ref_sq, rk, ck,
                                                        batch, n, m, c, st)
                : launch_form<Form::Bf16, kBidir, false>(src, ref, src_sq, ref_sq, rk, ck,
                                                         batch, n, m, c, st);
  else
    err = vec16 ? launch_form<Form::Fp32x3, kBidir, true>(src, ref, src_sq, ref_sq, rk,
                                                          ck, batch, n, m, c, st)
                : launch_form<Form::Fp32x3, kBidir, false>(src, ref, src_sq, ref_sq, rk,
                                                           ck, batch, n, m, c, st);
  if (err != cudaSuccess) return (int)err;
  const long long total = n_rows + n_cols;
  key_low_words<<<(unsigned int)((total + 255) / 256), 256, 0, st>>>(idx, n_rows, ridx,
                                                                    n_cols);
  return (int)cudaGetLastError();
}

}  // namespace match_core
