// Streaming second moments X^T Y plus the column sums of Y, for Hopper.
//
// Replaces the Pallas TPU kernels gram (_gram_kernel, reached through
// pl.pallas_call at src/repro/kernels/gram/gram.py:127 from gram at :104)
// and gram_cross (_gram_cross_kernel, pl.pallas_call at :179 from
// gram_cross at :152). One kernel computes both. For every slab z of a
// layer-stacked batch it writes
//     s2[z] = X[z]^T Y[z]  (Fx, Fy) fp32     s1[z] = colsum(Y[z])  (Fy,) fp32
//
// Bound on an H100 at 700 W: gram at the prune path's shape, L = 12 layers
// of N = 16 * 197 tokens by F = 3072, needs only the upper triangle of the
// symmetric X^T X, L N F (F + 1) = 357 GFLOP against 0.9 GB read and
// written: bound by operations on the CUDA cores (67 TFLOP/s fp32: 5.33 ms),
// some 20x over bytes. gram_cross at X (3152, 3072), Y (3152, 768): 14.9
// GFLOP, 0.22 ms.
//
// Design: each block owns one 128 x 128 output tile; each of its 256
// threads keeps an 8 x 8 fp32 register tile (products are fp32 FMAs, never
// TF32), and every 16-byte shared-memory load feeds 16 FMAs. One block runs
// on an SM (about 235 registers a thread; capping them at 128 for two
// blocks spilled and ran slower). The token axis streams through a ring
// of 4 stages of 16 tokens (the TPU grid's sequential n axis becomes this
// loop): a stage is 16 rows of 512 contiguous bytes of X and of Y, copied
// by 16-byte cp.async three stages ahead of the compute, one __syncthreads
// a stage. bf16 inputs are staged as bf16 and widened when read into
// registers. When X is Y (gram), only the tiles with tile row <= tile
// column run (300 of 576 at F = 3072), a diagonal tile stages X once, and
// an off-diagonal tile is written twice: as computed, and transposed from
// the same registers (each warp then writes whole 32-byte sectors), so s2
// is exactly symmetric. The column sums come from the blocks of tile row
// 0, which exists for every tile column, as pl.when(i == 0) does in
// _gram_cross_kernel. Work items are (layer, tile) pairs, all L layers of
// a tap in one launch: whole waves of pairs run whole, and the pairs of a
// last, partial wave are split over the tokens so that they fill one wave
// (gram_cross's 144 tiles on 132 SMs: 132 whole, 12 split 11 ways); the
// split items write fp32 partial tiles that a second kernel adds in split
// order. No atomics: the results are deterministic. Ragged N and F are
// zero-filled at the loads and masked at the stores: no padding copies.
// Inputs with a non-unit F stride or rows that are not 16-byte aligned are
// loaded element by element by the same kernel (a flag per tensor from the
// wrapper). Next step: a bf16 tensor-core gram once a path streams bf16
// statistics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;   // output rows of a block (columns of X)
constexpr int BN = 128;   // output columns of a block (columns of Y)
constexpr int BK = 16;    // tokens per stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

// four consecutive staged values, widened to fp32
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// Tokens [n0, n0 + BK) by columns [f0, f0 + 128) of a (n_end, f) slab into
// dst (BK x 128): zero past n_end and past f. vec: 16-byte cp.async chunks
// (unit F stride, rows 16-byte aligned); else element loads.
template <typename T>
__device__ __forceinline__ void load_stage(T* dst, const T* p, int64_t sn,
                                           int64_t sf, int n0, int n_end,
                                           int f0, int f, bool vec, int tid) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CPR = BM / E;                 // chunks per token row
    static_assert(BK * CPR % THREADS == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < BK * CPR / THREADS; ++it) {
      const int c = tid + it * THREADS;
      const int r = c / CPR, col = (c % CPR) * E;
      const int row = n0 + r, fc = f0 + col;
      int bytes = 0;
      const T* src = p;
      if (row < n_end && fc < f) {
        bytes = min(f - fc, E) * static_cast<int>(sizeof(T));
        src = p + row * sn + fc;
      }
      cp_async16(dst + r * BM + col, src, bytes);
    }
  } else {
#pragma unroll
    for (int it = 0; it < BK * BM / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / BM, col = e % BM;
      const int row = n0 + r, fc = f0 + col;
      dst[r * BM + col] =
          (row < n_end && fc < f) ? p[row * sn + fc * sf] : zero<T>();
    }
  }
}

// Which tile of which layer a work item computes, and over which tokens.
// Items [0, full) are whole (layer, tile) pairs in order; the pairs after
// them are each split over the tokens into `splits` items.
struct Item {
  int z, ti, tj, n_begin, n_end;
  int slot;        // partial slot, -1 for a whole item
};
__device__ __forceinline__ void tile_of(int tile, int nti, int ntj, int sym,
                                        int& ti, int& tj) {
  if (sym) {                        // upper triangle, row by row
    int t = tile;
    ti = 0;
    while (t >= nti - ti) {
      t -= nti - ti;
      ++ti;
    }
    tj = ti + t;
  } else {
    ti = tile / ntj;
    tj = tile % ntj;
  }
}
__device__ __forceinline__ Item item_of(int item, int n, int fx, int fy,
                                        int sym, int full, int splits,
                                        int chunk) {
  const int nti = (fx + BM - 1) / BM, ntj = (fy + BN - 1) / BN;
  const int tiles = sym ? nti * (nti + 1) / 2 : nti * ntj;
  Item it{0, 0, 0, 0, n, -1};
  int pair = item;
  if (item >= full) {
    const int r = item - full, split = r % splits;
    pair = full + r / splits;
    it.slot = r;
    it.n_begin = split * chunk;
    it.n_end = min(n, it.n_begin + chunk);
  }
  it.z = pair / tiles;
  tile_of(pair % tiles, nti, ntj, sym, it.ti, it.tj);
  return it;
}

// One 128 x 128 tile of s2 (and, in tile row 0, 128 column sums) over the
// item's tokens. Thread (tr, tc) owns output rows {tr*4 + m, 64 + tr*4 + m}
// and columns {tc*4 + q, 64 + tc*4 + q}, m, q < 4. A whole item writes s2
// and s1; a split item writes its partial tile to p2 (slot, BM, BN) and its
// partial column sums to p1 (slot, BN).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const T* __restrict__ x, const T* __restrict__ y,
            float* __restrict__ s2, float* __restrict__ s1,
            float* __restrict__ p2, float* __restrict__ p1, int n, int fx,
            int fy, int64_t sxl, int64_t sxn, int64_t sxf, int64_t syl,
            int64_t syn, int64_t syf, int sym, int vec, int full, int splits,
            int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // stages of xs, ys (BK, 128)

  const Item w = item_of(blockIdx.x, n, fx, fy, sym, full, splits, chunk);
  const int ti = w.ti, tj = w.tj, n_begin = w.n_begin, n_end = w.n_end;
  const int i0 = ti * BM, j0 = tj * BN;
  const bool same = sym && ti == tj;   // Y's columns are X's: stage once
  const bool colsum = ti == 0;
  const int64_t z = w.z;
  const T* xz = x + z * sxl;
  const T* yz = y + z * syl;
  const int ntiles = n_end > n_begin ? (n_end - n_begin + BK - 1) / BK : 0;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;

  auto issue = [&](int t) {
    T* xs = ring + (t % STAGES) * 2 * BK * BM;
    const int n0 = n_begin + t * BK;
    load_stage<T>(xs, xz, sxn, sxf, n0, n_end, i0, fx, vec & 1, tid);
    if (!same)
      load_stage<T>(xs + BK * BM, yz, syn, syf, n0, n_end, j0, fy, vec & 2,
                    tid);
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  float csum = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage t is in; every thread is done with t - 1
    if (t + STAGES - 1 < ntiles) issue(t + STAGES - 1);
    cp_async_commit();

    const T* xs = ring + (t % STAGES) * 2 * BK * BM;
    const T* ys = same ? xs : xs + BK * BM;
    if (colsum) {                   // column tid % BN, half the stage's rows
#pragma unroll
      for (int r = 0; r < BK / 2; ++r)
        csum += to_f32(ys[((tid / BN) * (BK / 2) + r) * BN + tid % BN]);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
      load4(xs + k * BM + tr * 4, a);
      load4(xs + k * BM + 64 + tr * 4, a + 4);
      load4(ys + k * BN + tc * 4, b);
      load4(ys + k * BN + 64 + tc * 4, b + 4);
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(a[m], b[q], acc[m][q]);
    }
  }
  cp_async_wait<0>();
  if (colsum) {                     // add the two halves' column sums
    __syncthreads();                // the ring is free
    float* half = reinterpret_cast<float*>(smem_raw);
    if (tid >= BN) half[tid - BN] = csum;
    __syncthreads();
    if (tid < BN) csum += half[tid];
  }

  if (w.slot >= 0) {                // a split item: the partial tile
    float* out = p2 + (int64_t)w.slot * BM * BN;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int i = m < 4 ? tr * 4 + m : 64 + tr * 4 + (m - 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(out + i * BN + 64 * h + tc * 4) =
            make_float4(acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2],
                        acc[m][4 * h + 3]);
    }
    if (colsum && tid < BN) p1[(int64_t)w.slot * BN + tid] = csum;
    return;
  }

  float* out = s2 + z * (int64_t)fx * fy;
  const bool vec_out = (fy & 3) == 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = i0 + (m < 4 ? tr * 4 + m : 64 + tr * 4 + (m - 4));
    if (i >= fx) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + 64 * h + tc * 4;
      float* dst = out + (int64_t)i * fy + j;
      if (vec_out && j + 3 < fy) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2],
                        acc[m][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < fy) dst[q] = acc[m][4 * h + q];
      }
    }
  }
  if (sym && ti != tj) {            // the mirrored tile: s2[j, i] = s2[i, j]
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + (q < 4 ? tc * 4 + q : 64 + tc * 4 + (q - 4));
      if (j >= fy) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 64 * h + tr * 4;
        float* dst = out + (int64_t)j * fy + i;
        if (vec_out && i + 3 < fx) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[4 * h][q], acc[4 * h + 1][q], acc[4 * h + 2][q],
                          acc[4 * h + 3][q]);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (i + m < fx) dst[m] = acc[4 * h + m][q];
        }
      }
    }
  }
  if (colsum && tid < BN && j0 + tid < fy) s1[z * fy + j0 + tid] = csum;
}

// The split pairs: each block adds 8 rows of one pair's partial tiles in
// split order (so the sums do not depend on the schedule) and writes them,
// mirrored too when X is Y; the first block of a pair in tile row 0 adds
// the column sums.
constexpr int RED_ROWS = 8;
__global__ void __launch_bounds__(THREADS)
reduce_splits(const float* __restrict__ p2, const float* __restrict__ p1,
              float* __restrict__ s2, float* __restrict__ s1, int n, int fx,
              int fy, int sym, int full, int splits) {
  const int per = BM / RED_ROWS;
  const int pr = blockIdx.x / per, part = blockIdx.x % per;
  const Item w = item_of(full + pr * splits, n, fx, fy, sym, full, splits, 0);
  const int i0 = w.ti * BM, j0 = w.tj * BN;
  const int a = part * RED_ROWS + threadIdx.x / (BN / 4);
  const int b = (threadIdx.x % (BN / 4)) * 4;
  const int64_t tile = (int64_t)BM * BN;
  const float* src = p2 + (int64_t)pr * splits * tile + a * BN + b;
  float4 sum = *reinterpret_cast<const float4*>(src);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = *reinterpret_cast<const float4*>(src + sp * tile);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
  float* out = s2 + (int64_t)w.z * fx * fy;
  const int i = i0 + a;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + b + q;
    if (i >= fx || j >= fy) continue;
    out[(int64_t)i * fy + j] = vals[q];
    if (sym && w.ti != w.tj) out[(int64_t)j * fy + i] = vals[q];
  }
  if (w.ti == 0 && part == 0 && threadIdx.x < BN) {
    const int j = j0 + threadIdx.x;
    float c = p1[(int64_t)pr * splits * BN + threadIdx.x];
    for (int sp = 1; sp < splits; ++sp)
      c += p1[((int64_t)pr * splits + sp) * BN + threadIdx.x];
    if (j < fy) s1[(int64_t)w.z * fy + j] = c;
  }
}

inline size_t smem_bytes(int itemsize) {
  return (size_t)STAGES * 2 * BK * BM * itemsize;
}

template <typename T>
int launch(const void* x, const void* y, float* s2, float* s1, float* p2,
           float* p1, int l, int n, int fx, int fy, int64_t sxl, int64_t sxn,
           int64_t sxf, int64_t syl, int64_t syn, int64_t syf, int sym,
           int vec, int full, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nti = (fx + BM - 1) / BM, ntj = (fy + BN - 1) / BN;
  const int pairs = l * (sym ? nti * (nti + 1) / 2 : nti * ntj);
  const int split_pairs = pairs - full;
  // tokens per split item, a whole number of stages
  const int chunk = ((n + splits - 1) / splits + BK - 1) / BK * BK;
  gram_kernel<T><<<full + split_pairs * splits, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), s2, s1, p2, p1, n,
      fx, fy, sxl, sxn, sxf, syl, syn, syf, sym, vec, full, splits, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || split_pairs == 0) return static_cast<int>(err);
  reduce_splits<<<split_pairs * (BM / RED_ROWS), THREADS, 0, stream>>>(
      p2, p1, s2, s1, n, fx, fy, sym, full, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (both x and y). x: (l, n, fx) and
// y: (l, n, fy) read through their strides; s2: (l, fx, fy) and s1: (l, fy)
// contiguous fp32. sym: x is y (fx == fy); only the upper triangle of tiles
// runs and s2 comes out exactly symmetric. vec: bit 0 (x), bit 1 (y) when
// the tensor's rows may be copied 16 bytes at a time. The (layer, tile)
// pairs [0, full) run whole; each later pair is split over the tokens into
// `splits` items whose partials go to p2 (pairs - full, splits, 128, 128)
// and p1 (pairs - full, splits, 128), added by a second kernel (p2 and p1
// may be null when full covers every pair). Returns cudaGetLastError()
// after the launches.
extern "C" int repro_gram_cross(int dtype, const void* x, const void* y,
                                void* s2, void* s1, void* p2, void* p1, int l,
                                int n, int fx, int fy, int64_t sxl,
                                int64_t sxn, int64_t sxf, int64_t syl,
                                int64_t syn, int64_t syf, int sym, int vec,
                                int full, int splits, void* stream) {
  const int nti = (fx + BM - 1) / BM, ntj = (fy + BN - 1) / BN;
  const int pairs = l * (sym ? nti * (nti + 1) / 2 : nti * ntj);
  if (splits < 1 || full < 0 || full > pairs || (sym && fx != fy) ||
      (full < pairs && (p2 == nullptr || p1 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto o2 = static_cast<float*>(s2);
  auto o1 = static_cast<float*>(s1);
  auto q2 = static_cast<float*>(p2);
  auto q1 = static_cast<float*>(p1);
  if (dtype == 0)
    return launch<float>(x, y, o2, o1, q2, q1, l, n, fx, fy, sxl, sxn, sxf,
                         syl, syn, syf, sym, vec, full, splits, st);
  if (dtype == 1)
    return launch<bf16>(x, y, o2, o1, q2, q1, l, n, fx, fy, sxl, sxn, sxf,
                        syl, syn, syf, sym, vec, full, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
