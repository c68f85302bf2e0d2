// Tiles in shared memory for the attention kernels (flash_attention.cu and
// flash_attention_bwd.cu): cp.async copies, strided element loads,
// ldmatrix and the bf16 mma.sync of the tensor cores. Each file that
// includes it gets its own copy (an unnamed namespace); _build.py hashes
// it beside the sources, so an edited header rebuilds the library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes < 16 reads that many and zero-fills the
// rest (0: the chunk is all zeros)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared (bytes 0: a zero)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

// Rows [r0, r0 + ROWS) of a (len, d) slice (row stride sr, element stride
// sd) into dst (ROWS x ld), columns [0, DPAD): zero past d and past len.
// vec: 16-byte cp.async chunks (sd == 1, rows 16-byte aligned), each thread
// one column of chunks where THREADS is a multiple of the chunks a row,
// else chunk c of the tile to thread c % THREADS; without vec, element
// loads by the same threads.
template <typename T, int ROWS, int THREADS, int DPAD>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* p,
                                          int64_t sr, int64_t sd, int r0,
                                          int len, int d, bool vec, int tid) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CPR = DPAD / E;               // chunks per row
    static_assert(DPAD % E == 0, "whole chunks");
    if constexpr (THREADS % CPR == 0 && ROWS % (THREADS / CPR) == 0) {
      constexpr int STEP = THREADS / CPR;       // rows a pass covers
      const int col = (tid % CPR) * E;
      const int bytes =
          col < d ? min(d - col, E) * static_cast<int>(sizeof(T)) : 0;
#pragma unroll
      for (int it = 0; it < ROWS / STEP; ++it) {
        const int r = tid / CPR + it * STEP;
        const int row = r0 + r;
        const bool in = row < len && bytes > 0;
        cp_async16(dst + r * ld + col, in ? p + row * sr + col : p,
                   in ? bytes : 0);
      }
    } else {
      constexpr int N = ROWS * CPR;
#pragma unroll
      for (int it = 0; it < (N + THREADS - 1) / THREADS; ++it) {
        const int c = tid + it * THREADS;
        if (N % THREADS != 0 && c >= N) break;
        const int r = c / CPR, col = (c % CPR) * E;
        const int row = r0 + r;
        const int bytes =
            col < d ? min(d - col, E) * static_cast<int>(sizeof(T)) : 0;
        const bool in = row < len && bytes > 0;
        cp_async16(dst + r * ld + col, in ? p + row * sr + col : p,
                   in ? bytes : 0);
      }
    }
  } else {
    static_assert(ROWS * DPAD % THREADS == 0, "tile shape");
#pragma unroll 4
    for (int it = 0; it < ROWS * DPAD / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / DPAD, col = e % DPAD;
      const int row = r0 + r;
      dst[r * ld + col] =
          (row < len && col < d) ? p[row * sr + col * sd] : zero<T>();
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The A fragment (16 x 16, row) of columns 16 kk .. + 16 of a 16-row
// accumulator held as n-tiles of 8 columns (x[n][4], the m16n8 C layout):
// the two n-tiles 2 kk and 2 kk + 1, rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[N][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

}  // namespace
