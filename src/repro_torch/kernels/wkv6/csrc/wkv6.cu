// RWKV-6 (Finch) recurrence for Hopper: a streaming one-token kernel and a
// chunk-parallel prefill.
//
// Replaces the Pallas TPU kernel wkv6 (_wkv6_kernel) in
// src/repro/kernels/wkv6/wkv6.py. Per head, with state S (N x N, fp32):
//   y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T.
// Inputs r, k, v, w (B,T,H,N) in fp32 or bf16 are read through their strides
// in the model's layout (16-byte vector loads where the n-stride is 1 and
// rows are aligned, element loads otherwise). u (H,N) and the states are
// contiguous fp32; y (B,T,H,N) has r's dtype. The final state goes to a
// caller-given buffer that may be the initial state itself: every kernel
// reads the initial state before it writes the final one, element by
// element in the same thread, so a decode step updates one layer's slice
// of the stacked cache in place. All products run on the CUDA cores in
// fp32 (TF32 or bf16 products would put the 1e-3 state gate at risk). No
// atomics: two calls give bitwise equal results.
//
// T = 1 (decode and the batch-1 walk), wkv6_step_kernel: one block per
// (head, batch row); each thread owns 16-byte column groups of 4 rows of S,
// reads them once (float4), writes S' once and reduces its partial y in
// shared memory. Bound on an H100: bytes, the 10.5 MB state in and out at
// B = 8, H = 40, N = 64 (3.1 us at 3.35 TB/s).
//
// T > 1 (prefill), three launches over chunks of 64 tokens, with c_i =
// sum_{j<=i} log2 w_j per channel over the chunk (c_{-1} = 0):
//   1. wkv6_chunk_state_kernel, per (chunk, head, batch row): the chunk's
//      decay 2^{c_{L-1}} and dS = (k * 2^{c_{L-1} - c})^T V into fp32
//      scratch (one N x N state per chunk);
//   2. wkv6_walk_kernel, per (head, batch row) and 1024 state entries:
//      S_start(0) = S0, S_start(c+1) = dec_c * S_start(c) + dS_c, written
//      over dS_c; the last one is the final state;
//   3. wkv6_chunk_out_kernel, per (chunk, head, batch row):
//      y_i = (r_i * 2^{c_{i-1}})^T S_start + sum_{j<i} A_ij v_j
//            + (r_i . (u * k_i)) v_i,
//      A_ij = sum_n r_in k_jn 2^{c_{i-1,n} - c_{j,n}}.
// At B = 1, T = 504 that is 8 x 40 = 320 blocks where one block per head
// gave 40. c is non-increasing, so every exponent is <= 0 (wkv6.py:12-15).
// A is built from sub-chunks of 16: for i in sub-chunk I and j in an
// earlier sub-chunk J, with b the last token of J,
//   A_ij = sum_n (r_in 2^{c_{i-1,n} - c_{b,n}}) (k_jn 2^{c_{b,n} - c_{j,n}}),
// both exponents <= 0, so six (16 x N)(N x 16) products of rows scaled once
// each; only the 4 diagonal 16 x 16 blocks keep an exponential per entry
// and channel (480 entries of the 2016 below the diagonal: with the scaled
// rows about 44 k exponentials a 64-token chunk, where a branch-free loop
// over all 64 x 64 entries takes 262 k).
// The products run as 4 x 4 (the output kernel's y: 2 x 4) register
// micro-tiles on 8- and 16-byte shared-memory reads (Q, A and the scaled
// rows stored transposed for that), since a warp issues shared-memory
// reads at a quarter of its FMA rate. Bound: operations, the 5N^2 + 5N per
// token and head of the plain recurrence (6.3 us at B = 1, T = 504); the
// output kernel's blocks are latency-bound, so it runs 512 threads (one
// block a SM at 157 KB of shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NMAX = 64;              // largest head dim
constexpr int CH = 64;                // tokens per chunk
constexpr int SUB = 16;               // tokens per sub-chunk
constexpr int THREADS = 256;
constexpr int OUT_THREADS = 512;      // the output kernel's block
constexpr int LS = NMAX + 1;          // row stride of tiles read a float
                                      // at a time (no bank conflicts)
constexpr int L4 = NMAX + 4;          // row stride of tiles read 16 bytes
                                      // at a time (rows 16-byte aligned)
constexpr int WALK = 1024;            // state entries a walk block owns
constexpr int DIAG = (SUB * (SUB - 1) / 2) * (CH / SUB);   // 480 entries
constexpr int PAIRS = 6;              // sub-chunk pairs J < I of a chunk
constexpr int RB = PAIRS * SUB;       // 96 scaled r rows, one set a pair
constexpr int KB = CH - SUB;          // 48 scaled k rows (sub-chunks 0..2)

// shared floats. State kernel: k, v (CH x L4), cz ((CH + 1) x LS: row 0
// zeros, row i + 1 holds c_i). Out kernel: r, k (CH x LS), v (CH x L4), cz,
// A^T (CH x L4), the scaled rows n-major (NMAX x RB, NMAX x KB), Q^T and
// S_start (NMAX x L4 each), u (NMAX).
constexpr int CZ = ((CH + 1) * LS + 3) & ~3;   // cz, keeping what follows
                                               // 16-byte aligned
constexpr int STATE_FLOATS = 2 * CH * L4 + CZ;
constexpr int OUT_FLOATS = 2 * CH * LS + CH * L4 + CZ + CH * L4 +
                           NMAX * (RB + KB) + 2 * NMAX * L4 + NMAX;

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

struct Params {
  const void *r, *k, *v, *w;
  const float* u;
  const float* s0;      // may be null (zeros) and may equal s_out
  float* s_out;
  void* y;
  float* ds;            // (B, H, nch, N, N) scratch: dS, then S_start
  float* dec;           // (B, H, nch, N) scratch: 2^{c_{L-1}}
  int t_len, n_heads, N, nch;
  int vec;              // bit 0..3: r, k, v, w rows load 16 bytes a time
  Strides st;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The values a thread of NT stages of rows t0 .. t0 + L - 1 of one (b, h)
// slice: fetch() issues every load into registers, store() writes them to
// a (token, n) tile as fp32 (lg: as log2 of the value, the decay's
// exponent). Callers fetch all their tiles before they store any, so the
// loads are in flight together.
template <typename T, int NT>
struct Rows {
  static constexpr int PER = CH * NMAX / NT;
  static constexpr int E = 16 / sizeof(T);          // elements a vector
  float x[PER];

  __device__ __forceinline__ void fetch(const T* __restrict__ p, int64_t st_t,
                                        int64_t st_n, int t0, int L, int N,
                                        bool vec, int tid) {
    if (vec) {
      const int cpr = N / E;
#pragma unroll
      for (int it = 0; it < PER / E; ++it) {
        const int e = tid + it * NT, i = e / cpr, n = (e % cpr) * E;
        if (i < L) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              p + (int64_t)(t0 + i) * st_t + n);
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int q = 0; q < E; ++q) x[it * E + q] = to_f32(v[q]);
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < PER; ++it) {
        const int e = tid + it * NT, i = e / N, n = e % N;
        if (i < L) x[it] = to_f32(p[(int64_t)(t0 + i) * st_t + n * st_n]);
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld, int L, int N,
                                        bool vec, bool lg, int tid) const {
    if (vec) {
      const int cpr = N / E;
#pragma unroll
      for (int it = 0; it < PER / E; ++it) {
        const int e = tid + it * NT, i = e / cpr, n = (e % cpr) * E;
        if (i < L)
#pragma unroll
          for (int q = 0; q < E; ++q) {
            const float f = x[it * E + q];
            dst[i * ld + n + q] = lg ? log2f(fmaxf(f, 1e-38f)) : f;
          }
      }
    } else {
#pragma unroll
      for (int it = 0; it < PER; ++it) {
        const int e = tid + it * NT, i = e / N, n = e % N;
        if (i < L) {
          const float f = x[it];
          dst[i * ld + n] = lg ? log2f(fmaxf(f, 1e-38f)) : f;
        }
      }
    }
  }
};

// cz[(i + 1) * LS + n] holds log2 w_i on entry and c_i on exit (i < L);
// row 0 is set to zeros. Each of NT threads scans one segment of a
// channel, then adds the totals of the segments before it.
template <int NT>
__device__ __forceinline__ void prefix_sums(float* cz, int L, int N,
                                            int tid) {
  constexpr int SEG = CH / (NT / NMAX);       // tokens a segment
  const int sg = tid / NMAX, sn = tid % NMAX;
  if (tid < NMAX) cz[tid] = 0.f;
  const int i_lo = sg * SEG, i_hi = min(i_lo + SEG, L);
  const bool scans = sn < N && i_lo < L;
  if (scans) {
    float acc = 0.f;
    for (int i = i_lo; i < i_hi; ++i) {
      acc += cz[(i + 1) * LS + sn];
      cz[(i + 1) * LS + sn] = acc;
    }
  }
  __syncthreads();
  float off = 0.f;
  if (scans)
    for (int s = 0; s < sg; ++s) off += cz[(s + 1) * SEG * LS + sn];
  __syncthreads();
  if (scans && sg > 0)
    for (int i = i_lo; i < i_hi; ++i) cz[(i + 1) * LS + sn] += off;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_step_kernel(const Params p) {
  __shared__ float rs[NMAX], ks[NMAX], vs[NMAX], ws[NMAX], us[NMAX];
  __shared__ float red[THREADS / 16][NMAX];
  __shared__ float bonus;
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y, N = p.N;
  const Strides& st = p.st;
  if (tid < N) {
    rs[tid] = to_f32(static_cast<const T*>(p.r)[b * st.r[0] + h * st.r[2] +
                                                tid * st.r[3]]);
    ks[tid] = to_f32(static_cast<const T*>(p.k)[b * st.k[0] + h * st.k[2] +
                                                tid * st.k[3]]);
    vs[tid] = to_f32(static_cast<const T*>(p.v)[b * st.v[0] + h * st.v[2] +
                                                tid * st.v[3]]);
    ws[tid] = to_f32(static_cast<const T*>(p.w)[b * st.w[0] + h * st.w[2] +
                                                tid * st.w[3]]);
    us[tid] = p.u[(int64_t)h * N + tid];
  }
  __syncthreads();
  if (tid < 32) {
    float d = 0.f;
    for (int n = tid; n < N; n += 32) d = fmaf(rs[n] * us[n], ks[n], d);
    d = warp_sum(d);
    if (tid == 0) bonus = d;
  }

  // thread (row set rg, column group cg): rows rg + 16 i, columns 4 cg ..
  // 4 cg + 3; float4 when the rows of S are 16-byte aligned
  const int cg = tid % 16, rg = tid / 16, c0 = 4 * cg;
  const int64_t sbase = ((int64_t)b * p.n_heads + h) * N * N;
  const bool vec4 = N % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(p.s0) |
                     reinterpret_cast<uintptr_t>(p.s_out)) % 16 == 0;
  float yp[4] = {0.f, 0.f, 0.f, 0.f};
  if (c0 < N) {
    float vc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) vc[c] = c0 + c < N ? vs[c0 + c] : 0.f;
#pragma unroll
    for (int i = 0; i < NMAX / 16; ++i) {
      const int n = rg + 16 * i;
      if (n < N) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        const int64_t at = sbase + (int64_t)n * N + c0;
        if (p.s0) {
          if (vec4) {
            const float4 f = *reinterpret_cast<const float4*>(p.s0 + at);
            s[0] = f.x; s[1] = f.y; s[2] = f.z; s[3] = f.w;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (c0 + c < N) s[c] = p.s0[at + c];
          }
        }
        const float rn = rs[n], wn = ws[n], kn = ks[n];
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          yp[c] = fmaf(rn, s[c], yp[c]);
          o[c] = fmaf(wn, s[c], kn * vc[c]);
        }
        if (vec4) {
          *reinterpret_cast<float4*>(p.s_out + at) =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < N) p.s_out[at + c] = o[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) red[rg][c0 + c] = yp[c];
  }
  __syncthreads();
  if (tid < N) {
    float y = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 16; ++i) y += red[i][tid];
    y = fmaf(bonus, vs[tid], y);
    static_cast<T*>(p.y)[b * st.y[0] + h * st.y[2] + tid * st.y[3]] =
        from_f32<T>(y);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_chunk_state_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* kk = smem;                    // k, then ke (CH x L4)
  float* vv = kk + CH * L4;
  float* cz = vv + CH * L4;
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, N = p.N;
  const int t0 = c * CH, L = min(CH, p.t_len - t0);
  const Strides& st = p.st;
  {
    Rows<T, THREADS> rk, rv, rw;
    rk.fetch(static_cast<const T*>(p.k) + b * st.k[0] + h * st.k[2], st.k[1],
             st.k[3], t0, L, N, p.vec & 2, tid);
    rv.fetch(static_cast<const T*>(p.v) + b * st.v[0] + h * st.v[2], st.v[1],
             st.v[3], t0, L, N, p.vec & 4, tid);
    rw.fetch(static_cast<const T*>(p.w) + b * st.w[0] + h * st.w[2], st.w[1],
             st.w[3], t0, L, N, p.vec & 8, tid);
    rk.store(kk, L4, L, N, p.vec & 2, false, tid);
    rv.store(vv, L4, L, N, p.vec & 4, false, tid);
    rw.store(cz + LS, LS, L, N, p.vec & 8, true, tid);
  }
  // rows past L and columns past N of k and v are zeros
#pragma unroll
  for (int j = 0; j < CH * NMAX / THREADS; ++j) {
    const int e = tid + j * THREADS, i = e / NMAX, n = e % NMAX;
    if (i >= L || n >= N) kk[i * L4 + n] = vv[i * L4 + n] = 0.f;
  }
  __syncthreads();
  prefix_sums<THREADS>(cz, L, N, tid);

  // ke = k * 2^{c_{L-1} - c_i}, in place
#pragma unroll 4
  for (int j = 0; j < CH * NMAX / THREADS; ++j) {
    const int e = tid + j * THREADS, i = e / NMAX, n = e % NMAX;
    if (i < L && n < N)
      kk[i * L4 + n] *= exp2f(cz[L * LS + n] - cz[(i + 1) * LS + n]);
  }
  __syncthreads();
  const int64_t bh = (int64_t)b * p.n_heads + h;
  float* dec = p.dec + (bh * p.nch + c) * N;
  if (tid < N) dec[tid] = exp2f(cz[L * LS + tid]);

  // dS = ke^T V: thread (tn, tm) owns rows 4 tn .. 4 tn + 3 and columns
  // 4 tm .. 4 tm + 3, two 16-byte reads for 16 products a token
  const int tn = tid / 16, tm = tid % 16;
  float ds[4][4] = {};
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    const float4 k4 = *reinterpret_cast<const float4*>(kk + i * L4 + 4 * tn);
    const float4 v4 = *reinterpret_cast<const float4*>(vv + i * L4 + 4 * tm);
    const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
    const float va[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) ds[a][bb] = fmaf(ka[a], va[bb], ds[a][bb]);
  }
  float* out = p.ds + (bh * p.nch + c) * N * N;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int n = 4 * tn + a, m = 4 * tm + bb;
      if (n < N && m < N) out[n * N + m] = ds[a][bb];
    }
}

// per state entry: S_start(c) over dS_c in place, the final state to s_out
// (after its own entry of s0 was read: s0 may be s_out)
__global__ void __launch_bounds__(THREADS)
wkv6_walk_kernel(const Params p) {
  constexpr int PER = WALK / THREADS;
  constexpr int BATCH = 8;            // chunks whose loads are in flight
  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, N = p.N, NN = N * N;
  const int64_t bh = (int64_t)b * p.n_heads + h;
  float run[PER];
  int ent[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    ent[j] = blockIdx.x * WALK + j * THREADS + tid;
    run[j] = (p.s0 && ent[j] < NN) ? p.s0[bh * NN + ent[j]] : 0.f;
  }
  for (int c0 = 0; c0 < p.nch; c0 += BATCH) {
    float d[BATCH][PER], dc[BATCH][PER];
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = c0 + q;
        const bool in = c < p.nch && ent[j] < NN;
        d[q][j] = in ? p.ds[(bh * p.nch + c) * NN + ent[j]] : 0.f;
        dc[q][j] = in ? p.dec[(bh * p.nch + c) * N + ent[j] / N] : 0.f;
      }
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = c0 + q;
        if (c < p.nch && ent[j] < NN) {
          p.ds[(bh * p.nch + c) * NN + ent[j]] = run[j];
          run[j] = fmaf(dc[q][j], run[j], d[q][j]);
        }
      }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (ent[j] < NN) p.s_out[bh * NN + ent[j]] = run[j];
}

template <typename T>
__global__ void __launch_bounds__(OUT_THREADS)
wkv6_chunk_out_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* rr = smem;                    // r (CH x LS)
  float* kk = rr + CH * LS;            // k (CH x LS)
  float* vv = kk + CH * LS;            // v (CH x L4)
  float* cz = vv + CH * L4;            // cz[(i + 1) * LS + n] = c_i
  float* at = cz + CZ;                 // A^T: at[j * L4 + i] = A_ij
  float* rb = at + CH * L4;            // rb[n * RB + 16 pair + il]
  float* kb = rb + NMAX * RB;          // kb[n * KB + j]
  float* qt = kb + NMAX * KB;          // Q^T: qt[n * L4 + i]
  float* S = qt + NMAX * L4;           // S_start[n * L4 + m]
  float* us = S + NMAX * L4;

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, N = p.N;
  const int t0 = c * CH, L = min(CH, p.t_len - t0);
  const Strides& st = p.st;
  const int64_t bh = (int64_t)b * p.n_heads + h;
  constexpr int NT = OUT_THREADS;
  constexpr int PER = NMAX * NMAX / NT;
  {
    // S_start and the chunk's r, k, v, w: every load issued before any store
    float sv[PER];
    const float* ss = p.ds + (bh * p.nch + c) * N * N;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * NT, n = e / NMAX, m = e % NMAX;
      sv[j] = n < N && m < N ? ss[n * N + m] : 0.f;
    }
    Rows<T, NT> xr, xk, xv, xw;
    xr.fetch(static_cast<const T*>(p.r) + b * st.r[0] + h * st.r[2], st.r[1],
             st.r[3], t0, L, N, p.vec & 1, tid);
    xk.fetch(static_cast<const T*>(p.k) + b * st.k[0] + h * st.k[2], st.k[1],
             st.k[3], t0, L, N, p.vec & 2, tid);
    xv.fetch(static_cast<const T*>(p.v) + b * st.v[0] + h * st.v[2], st.v[1],
             st.v[3], t0, L, N, p.vec & 4, tid);
    xw.fetch(static_cast<const T*>(p.w) + b * st.w[0] + h * st.w[2], st.w[1],
             st.w[3], t0, L, N, p.vec & 8, tid);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * NT;
      S[(e / NMAX) * L4 + e % NMAX] = sv[j];
      // A^T starts at zero: upper entries and rows past L stay so
      at[(e / NMAX) * L4 + e % NMAX] = 0.f;
      // v past L or N is zero (A V reads whole 4-column groups)
      vv[(e / NMAX) * L4 + e % NMAX] = 0.f;
    }
    xr.store(rr, LS, L, N, p.vec & 1, false, tid);
    xk.store(kk, LS, L, N, p.vec & 2, false, tid);
    __syncthreads();                   // zeros of vv before its values
    xv.store(vv, L4, L, N, p.vec & 4, false, tid);
    xw.store(cz + LS, LS, L, N, p.vec & 8, true, tid);
  }
  if (tid < N) us[tid] = p.u[(int64_t)h * N + tid];
  __syncthreads();
  prefix_sums<NT>(cz, L, N, tid);

  // the 16 x 16 diagonal blocks: A_ij with its own exponential per channel,
  // one (i, j) pair a thread
  {
    constexpr int DP = (DIAG + NT - 1) / NT;
    int pi[DP], pj[DP];
    bool on[DP];
#pragma unroll
    for (int s = 0; s < DP; ++s) {
      const int pr = tid + s * NT;
      const int blk = pr / 120, q = pr % 120;
      int il = static_cast<int>((1.f + sqrtf(1.f + 8.f * q)) * 0.5f);
      if (il * (il - 1) / 2 > q) --il;
      if ((il + 1) * il / 2 <= q) ++il;
      pi[s] = SUB * blk + il;
      pj[s] = SUB * blk + q - il * (il - 1) / 2;
      on[s] = pr < DIAG && pi[s] < L;
      if (!on[s]) pi[s] = pj[s] = 0;
    }
    float acc[DP] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int s = 0; s < DP; ++s)
        acc[s] = fmaf(rr[pi[s] * LS + n] * kk[pj[s] * LS + n],
                      exp2f(cz[pi[s] * LS + n] - cz[(pj[s] + 1) * LS + n]),
                      acc[s]);
#pragma unroll
    for (int s = 0; s < DP; ++s)
      if (on[s]) at[pj[s] * L4 + pi[s]] = acc[s];
  }
  // the bonus diagonal A_ii = sum_n r_in u_n k_in, eight threads a row
  {
    static_assert(NT == 8 * CH, "eight threads a row");
    const int i = tid / 8, part = tid % 8;
    float d = 0.f;
    if (i < L)
      for (int n = part; n < N; n += 8)
        d = fmaf(rr[i * LS + n] * us[n], kk[i * LS + n], d);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (i < L && part == 0) at[i * L4 + i] = d;
  }
  // rows scaled to the end b of sub-chunk J, n-major: for the pair (I, J),
  // rb = r_i 2^{c_{i-1} - c_b} (i in sub-chunk I) and kb = k_j 2^{c_b - c_j}
  // (j in sub-chunk J); both exponents are <= 0
#pragma unroll 4
  for (int j = 0; j < NMAX * RB / NT; ++j) {
    const int e = tid + j * NT, n = e / RB, row = e % RB;
    const int pr = row / SUB, I = pr < 1 ? 1 : pr < 3 ? 2 : 3;
    const int J = pr - I * (I - 1) / 2, i = SUB * I + row % SUB;
    rb[e] = i < L && n < N
        ? rr[i * LS + n] * exp2f(cz[i * LS + n] - cz[SUB * (J + 1) * LS + n])
        : 0.f;
  }
#pragma unroll 4
  for (int j = 0; j < NMAX * KB / NT; ++j) {
    const int e = tid + j * NT, n = e / KB, jr = e % KB;
    const int J = jr / SUB;
    kb[e] = jr < L && n < N
        ? kk[jr * LS + n] * exp2f(cz[SUB * (J + 1) * LS + n] -
                                  cz[(jr + 1) * LS + n])
        : 0.f;
  }
  // Q^T: q_i = r_i * 2^{c_{i-1}}
#pragma unroll 4
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * NT, n = e / CH, i = e % CH;
    qt[n * L4 + i] = i < L && n < N ? rr[i * LS + n] * exp2f(cz[i * LS + n])
                                    : 0.f;
  }
  __syncthreads();

  // off-diagonal blocks, 96 threads: pair (I, J), a 4 x 4 micro-tile of
  // its 16 x 16 block, two 16-byte reads for 16 products a channel
  if (tid < RB) {
    const int pr = tid / SUB, t = tid % SUB, ti = t / 4, tj = t % 4;
    const int I = pr < 1 ? 1 : pr < 3 ? 2 : 3, J = pr - I * (I - 1) / 2;
    float acc[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 r4 = *reinterpret_cast<const float4*>(
          rb + n * RB + SUB * pr + 4 * ti);
      const float4 k4 = *reinterpret_cast<const float4*>(
          kb + n * KB + SUB * J + 4 * tj);
      const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
      const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          acc[a][bb] = fmaf(ra[a], ka[bb], acc[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int i = SUB * I + 4 * ti + a, jj = SUB * J + 4 * tj + bb;
        if (i < L) at[jj * L4 + i] = acc[a][bb];
      }
  }
  __syncthreads();

  // y_i = q_i^T S_start + sum_{j <= i} A_ij v_j: thread (ti, tj) owns rows
  // 2 ti, 2 ti + 1 and columns 4 tj .. 4 tj + 3
  static_assert(NT == 32 * 16, "2 x 4 micro-tiles");
  const int ti = tid / 16, tj = tid % 16;
  if (2 * ti < L) {
    float acc[2][4] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float2 q2 = *reinterpret_cast<const float2*>(qt + n * L4 + 2 * ti);
      const float4 s4 = *reinterpret_cast<const float4*>(S + n * L4 + 4 * tj);
      const float qa[2] = {q2.x, q2.y};
      const float sa[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          acc[a][bb] = fmaf(qa[a], sa[bb], acc[a][bb]);
    }
    const int last = min(L - 1, 2 * ti + 1);
#pragma unroll 4
    for (int j = 0; j <= last; ++j) {
      const float2 a2 = *reinterpret_cast<const float2*>(at + j * L4 + 2 * ti);
      const float4 v4 = *reinterpret_cast<const float4*>(vv + j * L4 + 4 * tj);
      const float aa[2] = {a2.x, a2.y};
      const float va[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          acc[a][bb] = fmaf(aa[a], va[bb], acc[a][bb]);
    }
    T* yp = static_cast<T*>(p.y) + b * st.y[0] + h * st.y[2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int i = 2 * ti + a, m = 4 * tj + bb;
        if (i < L && m < N)
          yp[(int64_t)(t0 + i) * st.y[1] + m * st.y[3]] =
              from_f32<T>(acc[a][bb]);
      }
  }
}

template <typename K>
cudaError_t smem_attr(K kernel, int floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(float) * floats));
}

template <typename T>
int launch(const Params& p, int b, cudaStream_t stream) {
  if (p.t_len == 1) {
    wkv6_step_kernel<T><<<dim3(p.n_heads, b), THREADS, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  // once per instance and process (thread-safe static initialisers)
  static const cudaError_t a1 =
      smem_attr(wkv6_chunk_state_kernel<T>, STATE_FLOATS);
  static const cudaError_t a2 =
      smem_attr(wkv6_chunk_out_kernel<T>, OUT_FLOATS);
  if (a1 != cudaSuccess) return static_cast<int>(a1);
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  const dim3 chunks(p.nch, p.n_heads, b);
  wkv6_chunk_state_kernel<T><<<chunks, THREADS,
                               sizeof(float) * STATE_FLOATS, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_walk_kernel<<<dim3((p.N * p.N + WALK - 1) / WALK, p.n_heads, b),
                     THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_chunk_out_kernel<T><<<chunks, OUT_THREADS,
                             sizeof(float) * OUT_FLOATS, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y alike). u (H,N) and
// the states (B,H,N,N) are contiguous fp32; s0 may be null (zeros) and may
// equal s_out. T > 1 needs the scratch: ds (B,H,nch,N,N) and dec
// (B,H,nch,N) fp32 with nch = ceil(t_len / 64); T = 1 ignores it. vec: bits
// 0..3 set when r, k, v, w rows may be read 16 bytes at a time (n-stride 1,
// N a multiple of 16 bytes, other strides and base aligned). strides: 20
// int64 element strides, (b, t, h, n) of r, k, v, w and y. Requires b,
// t_len, n_heads >= 1, b <= 65535, n_heads <= 65535 and 1 <= N <= 64 (the
// wrapper checks). Returns cudaGetLastError() after the launches.
extern "C" int repro_wkv6(int dtype, const void* r, const void* k,
                          const void* v, const void* w, const void* u,
                          const void* s0, void* s_out, void* y, void* ds,
                          void* dec, int b, int t_len, int n_heads, int N,
                          int vec, const void* strides, void* stream) {
  const int nch = (t_len + CH - 1) / CH;
  if (b < 1 || t_len < 1 || n_heads < 1 || N < 1 || N > NMAX ||
      b > 65535 || n_heads > 65535 || (t_len > 1 && (!ds || !dec)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{r, k, v, w, static_cast<const float*>(u),
           static_cast<const float*>(s0), static_cast<float*>(s_out), y,
           static_cast<float*>(ds), static_cast<float*>(dec), t_len,
           n_heads, N, nch, vec, {}};
  const int64_t* s = static_cast<const int64_t*>(strides);
  for (int i = 0; i < 4; ++i) {
    p.st.r[i] = s[i];
    p.st.k[i] = s[4 + i];
    p.st.v[i] = s[8 + i];
    p.st.w[i] = s[12 + i];
    p.st.y[i] = s[16 + i];
  }
  auto str = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, b, str);
  if (dtype == 1) return launch<__nv_bfloat16>(p, b, str);
  return static_cast<int>(cudaErrorInvalidValue);
}
