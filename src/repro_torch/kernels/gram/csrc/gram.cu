// Streaming second moments X^T Y plus the column sums of Y, for Hopper.
//
// Replaces the Pallas TPU kernels gram / gram_cross (_gram_kernel,
// _gram_cross_kernel) in src/repro/kernels/gram/gram.py. One kernel computes
// both: gram(x) is gram_cross(x, x). For every slab z of a layer-stacked
// batch it writes
//     s2[z] = X[z]^T Y[z]   (Fx, Fy) fp32     s1[z] = colsum(Y[z])   (Fy,) fp32
//
// Bound on an H100: at the calibration shape (N = 16 * 197 tokens, F = 3072)
// one layer is 2 N F^2 = 59.5 GFLOP against about 76 MB read and written,
// so it is bound by operations (fp32 on the CUDA cores, 67 TFLOP/s at
// 700 W: about 0.9 ms) by some 40x over bytes (23 us at 3.35 TB/s).
// Design for that: each block owns one 128 x 128 output tile and walks the
// token axis in chunks of 8 rows staged in shared memory (the TPU grid's
// sequential n axis becomes this loop); each of its 256 threads keeps an
// 8 x 8 register tile, and every 16-byte shared-memory load feeds 16 FMAs.
// Products are fp32 FMAs, never TF32. gridDim.z runs over the stacked
// layers, so all L layers of a tap take one launch. Ragged N and F are
// masked at the loads and stores: no padding copies. The column sums come
// from the blocks of the first tile row (blockIdx.y == 0), as pl.when(i == 0)
// does in _gram_cross_kernel. There are no atomics, so results are
// deterministic. Later work: wgmma and TMA, double-buffered loads, and only
// the upper triangle when X is Y.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // output rows of a block (columns of X)
constexpr int BN = 128;   // output columns of a block (columns of Y)
constexpr int BK = 8;     // tokens per shared-memory chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Thread (tr, tc) owns output rows {tr*4 + m, 64 + tr*4 + m} and columns
// {tc*4 + n, 64 + tc*4 + n}, m, n < 4, so its operands are two float4 loads
// each from consecutive shared-memory words.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_cross_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  float* __restrict__ s2, float* __restrict__ s1,
                  int n, int fx, int fy,
                  int64_t sxl, int64_t sxn, int64_t sxf,
                  int64_t syl, int64_t syn, int64_t syf) {
  __shared__ __align__(16) float xs[BK][BM];
  __shared__ __align__(16) float ys[BK][BN];

  const int64_t z = blockIdx.z;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const T* xz = x + z * sxl;
  const T* yz = y + z * syl;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const bool colsum_block = blockIdx.y == 0;

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  float csum = 0.f;

  for (int n0 = 0; n0 < n; n0 += BK) {
#pragma unroll
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int r = e / BM, c = e % BM;
      const int row = n0 + r;
      const int xc = i0 + c, yc = j0 + c;
      xs[r][c] = (row < n && xc < fx) ? to_f32(xz[row * sxn + xc * sxf]) : 0.f;
      ys[r][c] = (row < n && yc < fy) ? to_f32(yz[row * syn + yc * syf]) : 0.f;
    }
    __syncthreads();
    if (colsum_block && tid < BN) {
#pragma unroll
      for (int r = 0; r < BK; ++r) csum += ys[r][tid];
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][tr * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][64 + tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ys[k][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ys[k][64 + tc * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(a[m], b[q], acc[m][q]);
    }
    __syncthreads();
  }

  float* s2z = s2 + z * (int64_t)fx * fy;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = i0 + (m < 4 ? tr * 4 + m : 64 + tr * 4 + (m - 4));
    if (i >= fx) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + (q < 4 ? tc * 4 + q : 64 + tc * 4 + (q - 4));
      if (j < fy) s2z[(int64_t)i * fy + j] = acc[m][q];
    }
  }
  if (colsum_block && tid < BN && j0 + tid < fy) s1[z * fy + j0 + tid] = csum;
}

template <typename T>
int launch(const void* x, const void* y, float* s2, float* s1, int l, int n,
           int fx, int fy, int64_t sxl, int64_t sxn, int64_t sxf,
           int64_t syl, int64_t syn, int64_t syf, cudaStream_t stream) {
  dim3 grid((fy + BN - 1) / BN, (fx + BM - 1) / BM, l);
  gram_cross_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), s2, s1, n, fx, fy,
      sxl, sxn, sxf, syl, syn, syf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (both x and y). x: (l, n, fx) and
// y: (l, n, fy) read through their strides; s2: (l, fx, fy) and s1: (l, fy)
// contiguous fp32. Returns cudaGetLastError() after the launch.
extern "C" int repro_gram_cross(int dtype, const void* x, const void* y,
                                void* s2, void* s1, int l, int n, int fx,
                                int fy, int64_t sxl, int64_t sxn, int64_t sxf,
                                int64_t syl, int64_t syn, int64_t syf,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto o2 = static_cast<float*>(s2);
  auto o1 = static_cast<float*>(s1);
  if (dtype == 0)
    return launch<float>(x, y, o2, o1, l, n, fx, fy, sxl, sxn, sxf, syl, syn,
                         syf, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, o2, o1, l, n, fx, fy, sxl, sxn, sxf,
                                 syl, syn, syf, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
