// RWKV-6 (Finch) recurrence for Hopper, chunked.
//
// Replaces the Pallas TPU kernel wkv6 (_wkv6_kernel) in
// src/repro/kernels/wkv6/wkv6.py. Per head, with state S (N x N, fp32):
//   y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T.
// Inputs r, k, v, w (B,T,H,N) in fp32 or bf16 are read through their strides
// in the model's layout (the TPU wrapper transposes them to (B,H,T,N); this
// kernel copies nothing). u (H,N) and the states are contiguous fp32; y
// (B,T,H,N) has r's dtype.
//
// Design: one block per (head, batch row) walks the sequence in chunks of
// up to 64 tokens (a loop inside the block takes the place of the TPU's
// sequential chunk grid axis). The state lives in shared memory for the
// whole walk; it is read once from the caller's initial state (or zeros)
// and written once at the end, so the output buffer may be the initial
// state itself (decode updates one layer's slice of the stacked cache in
// place). Per chunk of L tokens, with c_i = sum_{j<=i} log2 w_j per channel
// (a prefix sum over the chunk, c_{-1} = 0), as wkv6.py:38-64:
//   y_i  = (r_i * 2^{c_{i-1}})^T S0                                 [inter]
//        + sum_{j<i} (sum_n r_in k_jn 2^{c_{i-1,n} - c_{j,n}}) v_j
//        + (r_i . (u * k_i)) v_i                                    [intra]
//   S'   = 2^{c_{L-1}} * S0 + (k * 2^{c_{L-1} - c})^T V.
// c is non-increasing, so every exponent is <= 0 (wkv6.py:12-15): the
// (L, L, N) decay tensor is never stored, each attention entry takes its
// own exponentials. Any T >= 1 is taken: the last chunk is short and only
// its L valid rows are read (the TPU kernel needs T % 64 == 0). T = 1 is
// the decode case. All products run on the CUDA cores in fp32.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32): a decode step at B = 8,
// H = 40, N = 64 moves the 10.5 MB state in and out (3.1 us, bytes). A
// prefill of T = 504 at B = 1 moves about 13.6 MB (4 us) and does about
// 0.58 G fp32 operations of this chunked form, 42 M of them exponentials
// (about 9 us). With one block per head only 40 of the 132 SMs work, 8
// warps each, and the intra-chunk exponentials take most of the time: the
// attention loop is branch-free so that a thread's 16 entries overlap
// their latencies. Later work: chunk-parallel state passing (more blocks
// at B = 1), a second level of chunking that turns most exponentials into
// products, tensor-core products, tiles loaded one chunk ahead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NMAX = 64;              // largest head dim
constexpr int CH = 64;                // tokens per chunk
constexpr int THREADS = 256;
constexpr int SEGS = THREADS / NMAX;  // prefix-sum segments per channel
constexpr int SEG = CH / SEGS;        // tokens per segment
constexpr int LDT = NMAX + 1;         // row stride of the (token, n) tiles
constexpr int LDA = CH + 1;           // row stride of the attention tile

// shared memory, in floats: S (NMAX x NMAX), r/q, k/ke and v tiles
// (CH x LDT each), cz ((CH + 1) x LDT: row 0 zeros, row i + 1 holds c_i),
// att (CH x LDA), u (NMAX)
constexpr int SMEM_FLOATS =
    NMAX * NMAX + 3 * CH * LDT + (CH + 1) * LDT + CH * LDA + NMAX;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// element strides (b, t, h, n) of r, k, v, w and y
struct Strides {
  int64_t r[4], k[4], v[4], w[4], y[4];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* s0, float* s_out,
            T* __restrict__ y, int t_len, int n_heads, int N, Strides st) {
  extern __shared__ float smem[];
  float* S = smem;                     // S[n * NMAX + m]
  float* rq = S + NMAX * NMAX;         // r, then q = r * 2^{c_{i-1}}
  float* kk = rq + CH * LDT;           // k, then ke = k * 2^{c_{L-1} - c_i}
  float* vv = kk + CH * LDT;
  float* cz = vv + CH * LDT;           // cz[(i + 1) * LDT + n] = c_i
  float* att = cz + (CH + 1) * LDT;    // att[i * LDA + j], j <= i
  float* us = att + CH * LDA;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t sbase = ((int64_t)b * n_heads + h) * N * N;

  // the whole initial state is read before anything is written (in place)
  for (int e = tid; e < N * N; e += THREADS)
    S[(e / N) * NMAX + e % N] = s0 ? s0[sbase + e] : 0.f;
  if (tid < N) {
    us[tid] = u[(int64_t)h * N + tid];
    cz[tid] = 0.f;
  }
  const T* rp = r + b * st.r[0] + h * st.r[2];
  const T* kp = k + b * st.k[0] + h * st.k[2];
  const T* vp = v + b * st.v[0] + h * st.v[2];
  const T* wp = w + b * st.w[0] + h * st.w[2];
  T* yp = y + b * st.y[0] + h * st.y[2];

  // thread roles: (ti, tj) own rows i = ti + 16a and columns j (or m) =
  // tj + 16b of the 64 x 64 attention and output tiles; (warp, lane) own
  // state entries n = warp + 8a, m = lane + 32b; (sg, sn) run one 16-token
  // segment of channel sn's prefix sum
  const int ti = tid / 16, tj = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int sg = tid / NMAX, sn = tid % NMAX;

  for (int t0 = 0; t0 < t_len; t0 += CH) {
    const int L = min(CH, t_len - t0);
    __syncthreads();   // initial state and u staged (first chunk)
    // stage the chunk's r, k, v and log2 w: each thread issues the loads
    // of four elements before it stores any, so they are in flight together
    for (int e0 = tid; e0 < L * N; e0 += 4 * THREADS) {
      float x[4][4] = {};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = e0 + q * THREADS;
        if (e < L * N) {
          const int64_t t = t0 + e / N;
          const int n = e % N;
          x[q][0] = to_f32(rp[t * st.r[1] + n * st.r[3]]);
          x[q][1] = to_f32(kp[t * st.k[1] + n * st.k[3]]);
          x[q][2] = to_f32(vp[t * st.v[1] + n * st.v[3]]);
          x[q][3] = to_f32(wp[t * st.w[1] + n * st.w[3]]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = e0 + q * THREADS;
        if (e < L * N) {
          const int i = e / N, n = e % N;
          rq[i * LDT + n] = x[q][0];
          kk[i * LDT + n] = x[q][1];
          vv[i * LDT + n] = x[q][2];
          cz[(i + 1) * LDT + n] = log2f(fmaxf(x[q][3], 1e-38f));
        }
      }
    }
    __syncthreads();

    // inclusive prefix sum of log2 w over the chunk's valid rows, per
    // channel: each thread scans one segment, then adds the totals of the
    // segments before it
    const int i_lo = sg * SEG, i_hi = min(i_lo + SEG, L);
    const bool scans = sn < N && i_lo < L;
    if (scans) {
      float acc = 0.f;
      for (int i = i_lo; i < i_hi; ++i) {
        acc += cz[(i + 1) * LDT + sn];
        cz[(i + 1) * LDT + sn] = acc;
      }
    }
    __syncthreads();
    float off = 0.f;
    if (scans)
      for (int s = 0; s < sg; ++s) off += cz[(s + 1) * SEG * LDT + sn];
    __syncthreads();
    if (scans && sg > 0)
      for (int i = i_lo; i < i_hi; ++i) cz[(i + 1) * LDT + sn] += off;
    __syncthreads();

    // the bonus diagonal att[i][i] = sum_n r_in u_n k_in, four threads a row
    {
      const int i = tid / 4, part = tid % 4;
      float d = 0.f;
      if (i < L)
        for (int n = part; n < N; n += 4)
          d = fmaf(rq[i * LDT + n] * us[n], kk[i * LDT + n], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (i < L && part == 0) att[i * LDA + i] = d;
    }

    // att[i][j] = sum_n r_in k_jn 2^{c_{i-1,n} - c_{j,n}} for j < i. The
    // loop is branch-free (selects, not ifs), so the 16 entries a thread
    // owns overlap their exponentials; entries outside the triangle are
    // computed on a zero exponent and discarded
    {
      bool lower[4][4];
      bool any = false;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int i = ti + 16 * a, j = tj + 16 * bb;
          lower[a][bb] = i < L && j < i;
          any |= lower[a][bb];
        }
      if (any) {
        float acc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float ri[4], ci[4], kj[4], cj[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = ti + 16 * a;
            ri[a] = rq[i * LDT + n];
            ci[a] = cz[i * LDT + n];          // c_{i-1}
          }
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int j = tj + 16 * bb;
            kj[bb] = kk[j * LDT + n];
            cj[bb] = cz[(j + 1) * LDT + n];   // c_j
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
              const float e = exp2f(lower[a][bb] ? ci[a] - cj[bb] : 0.f);
              const float t = fmaf(ri[a] * kj[bb], e, acc[a][bb]);
              acc[a][bb] = lower[a][bb] ? t : acc[a][bb];
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb)
            if (lower[a][bb])
              att[(ti + 16 * a) * LDA + tj + 16 * bb] = acc[a][bb];
      }
    }
    __syncthreads();

    // q = r * 2^{c_{i-1}} and ke = k * 2^{c_{L-1} - c_i}, in place
    for (int e = tid; e < L * N; e += THREADS) {
      const int i = e / N, n = e % N;
      rq[i * LDT + n] *= exp2f(cz[i * LDT + n]);
      kk[i * LDT + n] *= exp2f(cz[L * LDT + n] - cz[(i + 1) * LDT + n]);
    }
    __syncthreads();

    // y_i = q_i^T S0 + sum_{j <= i} att[i][j] v_j
    {
      float acc[4][4] = {};
      const int last = min(L - 1, ti + 48);
      if (ti < L) {
        for (int n = 0; n < N; ++n) {
          float qi[4], sm[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) qi[a] = rq[(ti + 16 * a) * LDT + n];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) sm[bb] = S[n * NMAX + tj + 16 * bb];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb)
              acc[a][bb] = fmaf(qi[a], sm[bb], acc[a][bb]);
        }
        for (int j = 0; j <= last; ++j) {
          float aij[4], vj[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = ti + 16 * a;
            aij[a] = (i < L && j <= i) ? att[i * LDA + j] : 0.f;
          }
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) vj[bb] = vv[j * LDT + tj + 16 * bb];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb)
              acc[a][bb] = fmaf(aij[a], vj[bb], acc[a][bb]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int i = ti + 16 * a, m = tj + 16 * bb;
            if (i < L && m < N)
              yp[(int64_t)(t0 + i) * st.y[1] + m * st.y[3]] =
                  from_f32<T>(acc[a][bb]);
          }
      }
    }

    // S' = 2^{c_{L-1}} S0 + ke^T V, into registers; written after every
    // thread is done reading S0
    float ns[8][2];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int n = warp + 8 * a;
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int m = lane + 32 * bb;
        ns[a][bb] = (n < N && m < N)
                        ? exp2f(cz[L * LDT + n]) * S[n * NMAX + m] : 0.f;
      }
    }
    for (int i = 0; i < L; ++i) {
      float ke[8], vi[2];
#pragma unroll
      for (int a = 0; a < 8; ++a) ke[a] = kk[i * LDT + warp + 8 * a];
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) vi[bb] = vv[i * LDT + lane + 32 * bb];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
          ns[a][bb] = fmaf(ke[a], vi[bb], ns[a][bb]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int n = warp + 8 * a, m = lane + 32 * bb;
        if (n < N && m < N) S[n * NMAX + m] = ns[a][bb];
      }
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += THREADS)
    s_out[sbase + e] = S[(e / N) * NMAX + e % N];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, float* s_out, void* y, int b,
           int t_len, int n_heads, int N, const Strides& st,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<T><<<dim3(n_heads, b), THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0, s_out,
      static_cast<T*>(y), t_len, n_heads, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y alike). u (H,N) and
// the states (B,H,N,N) are contiguous fp32; s0 may be null (zeros) and may
// equal s_out. strides: 20 int64 element strides, (b, t, h, n) of r, k, v,
// w and y. Requires b, t_len, n_heads >= 1 and 1 <= N <= 64 (the wrapper
// checks). Returns cudaGetLastError() after the launch.
extern "C" int repro_wkv6(int dtype, const void* r, const void* k,
                          const void* v, const void* w, const void* u,
                          const void* s0, void* s_out, void* y, int b,
                          int t_len, int n_heads, int N, const void* strides,
                          void* stream) {
  if (b < 1 || t_len < 1 || n_heads < 1 || N < 1 || N > NMAX ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  const int64_t* s = static_cast<const int64_t*>(strides);
  for (int i = 0; i < 4; ++i) {
    st.r[i] = s[i];
    st.k[i] = s[4 + i];
    st.v[i] = s[8 + i];
    st.w[i] = s[12 + i];
    st.y[i] = s[16 + i];
  }
  auto str = static_cast<cudaStream_t>(stream);
  auto uf = static_cast<const float*>(u);
  auto s0f = static_cast<const float*>(s0);
  auto sof = static_cast<float*>(s_out);
  if (dtype == 0)
    return launch<float>(r, k, v, w, uf, s0f, sof, y, b, t_len, n_heads, N,
                         st, str);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, uf, s0f, sof, y, b, t_len,
                                 n_heads, N, st, str);
  return static_cast<int>(cudaErrorInvalidValue);
}
