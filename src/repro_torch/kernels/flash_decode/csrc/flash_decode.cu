// Split-KV single-token decode attention for Hopper.
//
// Replaces the Pallas TPU kernel decode_attention_splits (_decode_kernel) in
// src/repro/kernels/flash_decode/flash_decode.py, and the logsumexp merge
// that src/repro/kernels/flash_decode/ops.py runs after it. Inputs:
// q (B,H,dq), the cache k (B,S,Hkv,dq) and v (B,S,Hkv,dv) in its own layout,
// read through strides (no transpose, no copy of the cache), and valid (B,S)
// bytes. Query head h reads kv head h / g with g = H / Hkv (GQA).
//
// Phase 1, decode_split_kernel: one block per (split of bs keys, kv head,
// batch row). The block loads the g query heads of its kv head once,
// streams its split's K and V rows once in tiles of 64 keys, and serves all
// g heads from each tile (g = 6 for Qwen2-1.5B). Per tile it computes the
// (g, 64) logits, an online softmax per head and the (g, dv) accumulator
// update; it writes fp32 partials acc (B,Hkv,ns,g,dv), m and l
// (B,Hkv,ns,g). As flash_decode.py:38-41: masked keys get logit -1e30 and
// weight exactly 0, so a split with no valid key leaves m = -1e30, l = 0,
// acc = 0. Keys past the ragged end of S are masked the same way (the TPU
// kernel needs S % bs == 0; this one does not).
//
// Phase 2, decode_merge_kernel: one block per (head, batch row) merges the
// ns partials by logsumexp, acc / max(l, 1e-30), and writes o (B,H,dv) in
// q's dtype (ops.py:26-32).
//
// Bound on an H100: decoding reads the whole cache once per step, 2
// operations per cache element and head of the group, so it is bound by
// bytes: B*S*Hkv*(dq+dv)*itemsize (8.4 MB at B = 8, S = 1024, Hkv = 2,
// d = 128, bf16: 2.5 us at 3.35 TB/s). B*Hkv is only 16 there, so the
// wrapper splits S until about two blocks per SM are in flight; the merge
// re-reads only the small fp32 partials. Accumulation is fp32 for fp32 and
// bf16 inputs alike; the tiles are staged in shared memory as fp32. Later
// work: keep the tiles in bf16, load them with cp.async/TMA one tile ahead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;          // keys per shared-memory tile
constexpr int THREADS = 256;
constexpr int DMAX = 128;       // largest head dim
constexpr int GMAX = 32;        // largest group of query heads per kv head
constexpr int ACC = GMAX * DMAX / THREADS;   // accumulators per thread
constexpr int MERGE_THREADS = 128;           // >= DMAX
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

// element strides: q (b, h, d), k (b, s, h, d), v (b, s, h, d), valid (b, s),
// o (b, h, d)
struct Strides {
  int64_t qb, qh, qd, kb, ks, kh, kd, vb, vs, vh, vd, mb, ms, ob, oh, od;
};

inline size_t smem_bytes(int g, int dq, int dv) {
  return sizeof(float) * ((size_t)g * dq + (size_t)TK * (dq + 1) +
                          (size_t)TK * (dv + 1) + (size_t)g * (TK + 1) +
                          3 * (size_t)g) +
         sizeof(int) * TK;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int s_len, int n_kv, int g,
                    int dq, int dv, int bs, int ns, float scale, Strides st) {
  extern __shared__ float smem[];
  const int ldk = dq + 1, ldv = dv + 1, ldp = TK + 1;
  float* qs = smem;                    // (g, dq)
  float* ks = qs + g * dq;             // (TK, dq)
  float* vs = ks + TK * ldk;           // (TK, dv)
  float* ps = vs + TK * ldv;           // (g, TK) logits, then weights
  float* m_s = ps + g * ldp;           // running max per head
  float* l_s = m_s + g;                // running denominator per head
  float* c_s = l_s + g;                // this tile's rescale factor
  int* ok_s = reinterpret_cast<int*>(c_s + g);   // (TK) key is valid

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int s_begin = split * bs;
  const int s_end = min(s_begin + bs, s_len);

  const T* qp = q + b * st.qb + (int64_t)hk * g * st.qh;
  for (int e = tid; e < g * dq; e += THREADS) {
    const int h = e / dq, d = e % dq;
    qs[e] = to_f32(qp[h * st.qh + d * st.qd]);
  }
  if (tid < g) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;
  const uint8_t* vm = valid + b * st.mb;

  for (int s0 = s_begin; s0 < s_end; s0 += TK) {
    const int n = min(TK, s_end - s0);
    __syncthreads();   // previous tile consumed; q, m, l set on the first
    for (int e = tid; e < TK * dq; e += THREADS) {
      const int r = e / dq, d = e % dq;
      ks[r * ldk + d] = r < n ? to_f32(kp[(s0 + r) * st.ks + d * st.kd]) : 0.f;
    }
    for (int e = tid; e < TK * dv; e += THREADS) {
      const int r = e / dv, d = e % dv;
      vs[r * ldv + d] = r < n ? to_f32(vp[(s0 + r) * st.vs + d * st.vd]) : 0.f;
    }
    if (tid < TK) ok_s[tid] = tid < n && vm[(s0 + tid) * st.ms] != 0;
    __syncthreads();

    // logits (g, TK): one dot product of length dq per entry
    for (int e = tid; e < g * TK; e += THREADS) {
      const int h = e / TK, r = e % TK;
      const float* qr = qs + h * dq;
      const float* kr = ks + r * ldk;
      float s = 0.f;
      for (int d = 0; d < dq; ++d) s = fmaf(qr[d], kr[d], s);
      ps[h * ldp + r] = ok_s[r] ? s * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int h = warp; h < g; h += THREADS / 32) {
      float* pr = ps + h * ldp;
      float mx = NEG_INF;
      for (int r = lane; r < TK; r += 32) mx = fmaxf(mx, pr[r]);
      mx = warp_max(mx);
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < TK; r += 32) {
        const float p = ok_s[r] ? expf(pr[r] - m_new) : 0.f;
        pr[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
        c_s[h] = corr;
      }
    }
    __syncthreads();

    // acc (g, dv) += P V; thread tid owns entries tid + THREADS * j
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int o = tid + j * THREADS;
      if (o < g * dv) {
        const int h = o / dv, c = o % dv;
        const float* pr = ps + h * ldp;
        float a = acc[j] * c_s[h];
        for (int r = 0; r < n; ++r) a = fmaf(pr[r], vs[r * ldv + c], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();   // m_s, l_s final (also for a split with no tile)

  const int64_t part = ((int64_t)(b * n_kv + hk) * ns + split) * g;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int o = tid + j * THREADS;
    if (o < g * dv) acc_out[part * dv + o] = acc[j];
  }
  if (tid < g) {
    m_out[part + tid] = m_s[tid];
    l_out[part + tid] = l_s[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                    const float* __restrict__ l, T* __restrict__ o,
                    int n_kv, int g, int dv, int ns, Strides st) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int hk = h / g, hg = h % g;
  // partial (b, hk, s, hg) sits at ((b * n_kv + hk) * ns + s) * g + hg
  const int64_t base = (int64_t)(b * n_kv + hk) * ns * g + hg;
  float m_max = -INFINITY;
  for (int s = 0; s < ns; ++s) m_max = fmaxf(m_max, m[base + (int64_t)s * g]);
  float l_tot = 0.f, a_tot = 0.f;
  for (int s = 0; s < ns; ++s) {
    const int64_t i = base + (int64_t)s * g;
    const float corr = expf(m[i] - m_max);
    l_tot += l[i] * corr;
    if (c < dv) a_tot += acc[i * dv + c] * corr;
  }
  if (c < dv)
    o[b * st.ob + h * st.oh + c * st.od] =
        from_f32<T>(a_tot / fmaxf(l_tot, 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           float* acc, float* m, float* l, void* o, int b, int s_len,
           int n_heads, int n_kv, int dq, int dv, int bs, float scale,
           const Strides& st, cudaStream_t stream) {
  const int g = n_heads / n_kv;
  const int ns = (s_len + bs - 1) / bs;
  const size_t smem = smem_bytes(g, dq, dv);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<T><<<dim3(ns, n_kv, b), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, acc, m, l, s_len, n_kv, g, dq, dv, bs,
      ns, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T><<<dim3(n_heads, b), MERGE_THREADS, 0, stream>>>(
      acc, m, l, static_cast<T*>(o), n_kv, g, dv, ns, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); valid: bytes,
// nonzero = key may be attended. acc (B,Hkv,ns,g,dv), m and l (B,Hkv,ns,g)
// are contiguous fp32 scratch with ns = ceil(s_len / bs). strides: 16 int64
// element strides, (b, h, d) of q, (b, s, h, d) of k and v, (b, s) of
// valid, (b, h, d) of o. Requires 1 <= dq, dv <= 128, n_heads % n_kv == 0,
// n_heads / n_kv <= 32, s_len >= 1, bs >= 1 (the wrapper checks). Returns
// cudaGetLastError() after the launches.
extern "C" int repro_flash_decode(int dtype, const void* q, const void* k,
                                  const void* v, const void* valid, void* acc,
                                  void* m, void* l, void* o, int b, int s_len,
                                  int n_heads, int n_kv, int dq, int dv,
                                  int bs, float scale, const void* strides,
                                  void* stream) {
  if (dq < 1 || dv < 1 || dq > DMAX || dv > DMAX || n_kv < 1 ||
      n_heads % n_kv != 0 || n_heads / n_kv > GMAX || s_len < 1 || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = static_cast<const int64_t*>(strides);
  const Strides st{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6],  s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]};
  auto str = static_cast<cudaStream_t>(stream);
  auto vm = static_cast<const uint8_t*>(valid);
  auto a = static_cast<float*>(acc);
  auto mm = static_cast<float*>(m);
  auto ll = static_cast<float*>(l);
  if (dtype == 0)
    return launch<float>(q, k, v, vm, a, mm, ll, o, b, s_len, n_heads, n_kv,
                         dq, dv, bs, scale, st, str);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, vm, a, mm, ll, o, b, s_len,
                                 n_heads, n_kv, dq, dv, bs, scale, st, str);
  return static_cast<int>(cudaErrorInvalidValue);
}
