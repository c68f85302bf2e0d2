// Forward online-softmax attention for Hopper.
//
// Replaces the Pallas TPU kernel flash_attention (_flash_kernel) in
// src/repro/kernels/flash_attention/flash_attention.py. Inputs
// q (B,T,H,dq), k (B,S,Hkv,dq), v (B,S,Hkv,dv) are read through their
// strides (no transposes); the output o (B,T,H,dv) has q's dtype. Query head
// h reads kv head h / (H / Hkv) (GQA). Masks: causal with right-aligned
// queries (query row t sits at absolute position t + S - T), an optional
// sliding window, or none. Masked logits are -1e30 and the denominator is
// floored at 1e-30, exactly as flash_attention.py:55-68; keys past the
// ragged end of S get zero weight, and query rows past T are not written.
//
// Bound on an H100: DeiT-Base at B = 16 is 2 B H T S (dq + dv) = 1.9 GFLOP
// per layer against 39 MB of q, k, v and o, so fp32 work on the CUDA cores
// (67 TFLOP/s at 700 W: 28 us) and bytes (3.35 TB/s: 12 us) are of one
// order; the kernel is bound by operations. Design: one block per
// (query tile of 64, head, batch); K and V tiles of 64 rows are staged in
// shared memory, the 64 x 64 logit tile goes through shared memory, and the
// running max, denominator and the (64, dv) accumulator stay fp32 (the
// accumulator in registers, 4 threads per query row). kv tiles that the
// causal or window mask hides from every row of the query tile are skipped,
// as ops.py:112-118 does. Shared memory is dynamic (up to 114 KB at
// d = 128, above the 48 KB static limit). Later work: tensor-core (wgmma)
// products and TMA loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr int DMAX = 128;
constexpr float NEG_INF = -1e30f;

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

struct Strides {
  int64_t qb, qt, qh, qd, kb, kt, kh, kd, vb, vt, vh, vd, ob, ot, oh, od;
};

inline size_t smem_bytes(int dq, int dv) {
  return sizeof(float) * (size_t)(BQ * (dq + 1) + BKV * (dq + 1) +
                                  BKV * (dv + 1) + BQ * (BKV + 1) + 3 * BQ);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int t_len,
                 int s_len, int n_heads, int n_kv, int dq, int dv, float scale,
                 int causal, int use_window, int window, Strides st) {
  extern __shared__ float smem[];
  const int ldq = dq + 1, ldv = dv + 1, ldp = BKV + 1;
  float* qs = smem;                    // (BQ, dq)
  float* ks = qs + BQ * ldq;           // (BKV, dq)
  float* vs = ks + BKV * ldq;          // (BKV, dv)
  float* ps = vs + BKV * ldv;          // (BQ, BKV) logits, then weights
  float* m_s = ps + BQ * ldp;          // running max
  float* l_s = m_s + BQ;               // running denominator
  float* c_s = l_s + BQ;               // this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv);
  const int off = s_len - t_len;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;

  for (int e = tid; e < BQ * dq; e += THREADS) {
    const int r = e / dq, d = e % dq;
    qs[r * ldq + d] =
        (q0 + r < t_len) ? to_f32(qp[(q0 + r) * st.qt + d * st.qd]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // logit tile: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
  const int ty = tid / 16, tx = tid % 16;
  // row statistics and P V: 4 threads per query row
  const int row = tid / 4, part = tid % 4;
  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.f;

  // absolute positions of the tile's first and last real query rows
  const int qpos_lo = q0 + off;
  const int qpos_hi = min(q0 + BQ, t_len) - 1 + off;

  for (int k0 = 0; k0 < s_len; k0 += BKV) {
    const int kpos_hi = min(k0 + BKV, s_len) - 1;
    if (causal && k0 > qpos_hi) break;            // every later tile too
    if (use_window && kpos_hi <= qpos_lo - window) continue;

    __syncthreads();   // previous tile's ks, vs, ps are consumed
    for (int e = tid; e < BKV * dq; e += THREADS) {
      const int r = e / dq, d = e % dq;
      ks[r * ldq + d] =
          (k0 + r < s_len) ? to_f32(kp[(k0 + r) * st.kt + d * st.kd]) : 0.f;
    }
    for (int e = tid; e < BKV * dv; e += THREADS) {
      const int r = e / dv, d = e % dv;
      vs[r * ldv + d] =
          (k0 + r < s_len) ? to_f32(vp[(k0 + r) * st.vt + d * st.vd]) : 0.f;
    }
    __syncthreads();

    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < dq; ++d) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ldq + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * ldq + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qpos = q0 + r + off;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int kpos = k0 + c;
          float val = s[i][j] * scale;
          if (kpos >= s_len) {
            val = -INFINITY;                       // not a key: no weight
          } else if ((causal && kpos > qpos) ||
                     (use_window && kpos <= qpos - window)) {
            val = NEG_INF;
          }
          ps[r * ldp + c] = val;
        }
      }
    }
    __syncthreads();

    {
      const float m_prev = m_s[row];
      float mx = -INFINITY;
#pragma unroll
      for (int c = part; c < BKV; c += 4) mx = fmaxf(mx, ps[row * ldp + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = part; c < BKV; c += 4) {
        const float p = expf(ps[row * ldp + c] - m_new);
        ps[row * ldp + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
        c_s[row] = corr;
      }
    }
    __syncthreads();

    {
      const float corr = c_s[row];
#pragma unroll
      for (int j = 0; j < DMAX / 4; ++j) acc[j] *= corr;
      for (int kk = 0; kk < BKV; ++kk) {
        const float p = ps[row * ldp + kk];
        const float* vrow = vs + kk * ldv;
#pragma unroll
        for (int j = 0; j < DMAX / 4; ++j) {
          const int c = part + 4 * j;
          if (c < dv) acc[j] = fmaf(p, vrow[c], acc[j]);
        }
      }
    }
  }

  __syncthreads();   // l_s is final (also when every kv tile was skipped)
  if (q0 + row < t_len) {
    const float denom = fmaxf(l_s[row], 1e-30f);
    T* op = o + b * st.ob + (q0 + row) * st.ot + h * st.oh;
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int c = part + 4 * j;
      if (c < dv) op[c * st.od] = from_f32<T>(acc[j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int t_len, int s_len, int n_heads, int n_kv, int dq, int dv,
           float scale, int causal, int use_window, int window,
           const Strides& st, cudaStream_t stream) {
  const size_t smem = smem_bytes(dq, dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((t_len + BQ - 1) / BQ, n_heads, b);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_len, s_len, n_heads,
      n_kv, dq, dv, scale, causal, use_window, window, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). strides: 16
// int64 element strides, (b, t, h, d) of q, k, v, o in that order.
// Requires dq, dv <= 128 and n_heads % n_kv == 0 (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_fwd(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* o, int b, int t_len, int s_len,
                                         int n_heads, int n_kv, int dq, int dv,
                                         float scale, int causal,
                                         int use_window, int window,
                                         const void* strides, void* stream) {
  if (dq > DMAX || dv > DMAX || dq < 1 || dv < 1 || n_kv < 1 ||
      n_heads % n_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = static_cast<const int64_t*>(strides);
  const Strides st{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6],  s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]};
  auto str = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, b, t_len, s_len, n_heads, n_kv, dq, dv,
                         scale, causal, use_window, window, st, str);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, b, t_len, s_len, n_heads, n_kv,
                                 dq, dv, scale, causal, use_window, window, st,
                                 str);
  return static_cast<int>(cudaErrorInvalidValue);
}
