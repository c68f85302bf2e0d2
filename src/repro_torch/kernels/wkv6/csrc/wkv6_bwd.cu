// Backward of the RWKV-6 recurrence for Hopper: dr, dk, dv, dw, du and the
// initial state's gradient.
//
// Replaces no Pallas kernel: the TPU kernel wkv6 (src/repro/kernels/wkv6/
// wkv6.py:76) is forward only, and the JAX package trains by
// differentiating its jnp paths (ops.py: ref, _chunked). The port's plain
// version serves CPU tensors only, so the gradient on the card is this
// kernel. Per head, with S_t = diag(w_t) S_{t-1} + k_t v_t^T, y_t =
// S_{t-1}^T r_t + (r_t . (u * k_t)) v_t, dS_t the gradient of S_t and
// dS_T the final state's:
//   dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
//   dk_t = dS_t v_t + u r_t (v_t . dy_t)
//   dv_t = dS_t^T k_t + (sum_n u r_t k_t) dy_t
//   dw_t = rowsum(dS_t * S_{t-1})              (the direct form)
//   du  += r_t k_t (v_t . dy_t)
//   dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T.
// dw is taken in the direct form, on the forward's states recomputed from
// each 64-token chunk's start state (the forward kernel's walk leaves them
// in its scratch; the wrapper keeps them). The log form (d log w from
// reverse cumulative sums of r dr - k dk, divided by w) cancels at small w;
// no state is ever divided back by w. Rows of S are independent, so dr,
// dk, dw and du are local to a row; only dv sums over rows.
//
// Four launches over the forward's chunks of 64 tokens:
//   1. wkv6_bwd_delta_kernel, per (chunk, head, batch row): the chunk's
//      decay P = prod_i w_i and D = sum_i diag(prod_{j<i} w_j) r_i dy_i^T
//      (prefix products taken directly, not through logarithms);
//   2. wkv6_bwd_walk_kernel, per (head, batch row) and 1024 entries, the
//      forward's walk run backwards: G = dS_T, then for the chunks from the
//      last, G_c = G written over D_c and G = P_c G + D_c; the last G is
//      dS_0, the initial state's gradient;
//   3. wkv6_bwd_grad_kernel, per (chunk, head, batch row), 512 threads:
//      thread (row n, eighth q) holds dS[n, 8q .. 8q + 7] from G_c and
//      walks the chunk's tokens backwards in sub-chunks of 8. A sub-chunk's
//      states S_{t-1} are recomputed from the chunk's start state into
//      registers (the start state's row advanced through the tokens before
//      it: at most 56 steps of one FMA an entry), dr is taken on the way,
//      then dk, dw (eight-lane shuffle sums) and the rows' dv terms; a
//      warp's four rows are summed by a shuffle reduce-scatter and the 16
//      warps' partial dv in shared memory in a fixed order;
//   4. wkv6_bwd_du_kernel, per head: du summed over batch rows and chunks
//      in a fixed order.
// All products run on the CUDA cores in fp32; no atomics, so two calls
// give bitwise equal results. Bound on an H100: operations, 14 N^2 + 16 N
// a token and head (the reverse recurrence with the forward's states
// recomputed): 0.071 ms at RWKV6-3B's train shape (B 4, T 512, H 40, N 64)
// at 67 TFLOP/s, against 0.028 ms for its 94 MB of bf16 traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NMAX = 64;                 // largest head dim
constexpr int CH = 64;                   // tokens a chunk (the forward's)
constexpr int SUB = 8;                   // tokens a sub-chunk (kernel 3)
constexpr int THREADS = 256;             // kernels 1 and 2
constexpr int GRAD_THREADS = 512;        // kernel 3: 64 rows x 8 eighths
constexpr int WARPS = GRAD_THREADS / 32;
constexpr int COLS = NMAX / 8;           // columns a kernel-3 thread holds
constexpr int WALK = 1024;               // entries a walk block owns
constexpr int TILE = CH * NMAX;          // one (token, n) tile of floats

// shared floats. Delta kernel: r, dy, w tiles. Grad kernel: r, k, w, v, dy
// tiles, the dr, dk, dw tiles, the partial dv of a sub-chunk, v.dy and the
// bonus a token, u.
constexpr int DELTA_FLOATS = 3 * TILE;
constexpr int GRAD_FLOATS = 8 * TILE + SUB * WARPS * NMAX + 2 * CH + NMAX;

static_assert(GRAD_THREADS == NMAX * 8, "eight threads a row");
static_assert(GRAD_THREADS == SUB * NMAX, "one dv entry a thread");

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

// element strides (b, t, h, n) of r, k, v, w and dy
struct Strides {
  int64_t r[4], k[4], v[4], w[4], dy[4];
};

struct Params {
  const void *r, *k, *v, *w, *dy;
  const float* u;
  const float* starts;  // (B, H, nch, N, N) chunk start states; null: zeros
  const float* dstate;  // (B, H, N, N) final state's gradient; null: zeros
  float* dstate0;       // (B, H, N, N) initial state's gradient; null: none
  void *dr, *dk, *dv, *dw;   // (B, T, H, N) contiguous, r's dtype
  float* du;            // (H, N)
  float* dg;            // (B, H, nch, N, N) scratch: D_c, then G_c
  float* dec;           // (B, H, nch, N) scratch: the chunk's decay
  float* dup;           // (B, H, nch, N) scratch: the chunk's du
  int t_len, n_heads, N, nch;
  int vec;              // bits 0..4: r, k, v, w, dy rows 16 bytes a time
  Strides st;
};

// tokens t0 .. t0 + L - 1 of one (b, h) slice into dst[i * NMAX + n] as
// fp32; zeros past L and past N
template <typename T, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ p,
                                          int64_t st_t, int64_t st_n, int t0,
                                          int L, int N, bool vec, int tid) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int VPR = NMAX / E;               // vectors a tile row
    const int cpr = N / E;                      // of them in the input
#pragma unroll
    for (int it = 0; it < CH * VPR / NT; ++it) {
      const int e = tid + it * NT, i = e / VPR, c = e % VPR;
      float x[E];
#pragma unroll
      for (int q = 0; q < E; ++q) x[q] = 0.f;
      if (i < L && c < cpr) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            p + (int64_t)(t0 + i) * st_t + c * E);
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < E; ++q) x[q] = to_f32(v[q]);
      }
#pragma unroll
      for (int q = 0; q < E; ++q) dst[i * NMAX + c * E + q] = x[q];
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < TILE / NT; ++it) {
      const int e = tid + it * NT, i = e / NMAX, n = e % NMAX;
      dst[e] = i < L && n < N
                   ? to_f32(p[(int64_t)(t0 + i) * st_t + n * st_n])
                   : 0.f;
    }
  }
}

// sum over the eight lanes of a row (lanes 8j .. 8j + 7 of a warp)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_delta_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* rr = smem;                     // r, then r_i prod_{j<i} w_j
  float* dd = rr + TILE;                // dy
  float* ww = dd + TILE;                // w
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, N = p.N;
  const int t0 = c * CH, L = min(CH, p.t_len - t0);
  const Strides& st = p.st;
  load_tile<T, THREADS>(rr, static_cast<const T*>(p.r) + b * st.r[0] +
                        h * st.r[2], st.r[1], st.r[3], t0, L, N, p.vec & 1,
                        tid);
  load_tile<T, THREADS>(dd, static_cast<const T*>(p.dy) + b * st.dy[0] +
                        h * st.dy[2], st.dy[1], st.dy[3], t0, L, N,
                        p.vec & 16, tid);
  load_tile<T, THREADS>(ww, static_cast<const T*>(p.w) + b * st.w[0] +
                        h * st.w[2], st.w[1], st.w[3], t0, L, N, p.vec & 8,
                        tid);
  __syncthreads();
  const int64_t bh = (int64_t)b * p.n_heads + h;
  if (tid < NMAX) {
    float pr = 1.f;
    for (int i = 0; i < L; ++i) {
      rr[i * NMAX + tid] *= pr;
      pr *= ww[i * NMAX + tid];
    }
    if (tid < N) p.dec[(bh * p.nch + c) * N + tid] = pr;
  }
  __syncthreads();
  // D = rr^T dy: thread (tn, tm) owns rows 4 tn .. 4 tn + 3 and columns
  // 4 tm .. 4 tm + 3
  const int tn = tid / 16, tm = tid % 16;
  float acc[4][4] = {};
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    const float4 r4 = *reinterpret_cast<const float4*>(rr + i * NMAX + 4 * tn);
    const float4 d4 = *reinterpret_cast<const float4*>(dd + i * NMAX + 4 * tm);
    const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
    const float da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        acc[a][bb] = fmaf(ra[a], da[bb], acc[a][bb]);
  }
  float* out = p.dg + (bh * p.nch + c) * N * N;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int n = 4 * tn + a, m = 4 * tm + bb;
      if (n < N && m < N) out[n * N + m] = acc[a][bb];
    }
}

// per state entry, over the chunks from the last: G_c over D_c, then
// G = dec_c G + D_c; the last G is dS_0
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_walk_kernel(const Params p) {
  constexpr int PER = WALK / THREADS;
  constexpr int BATCH = 8;              // chunks whose loads are in flight
  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, N = p.N, NN = N * N;
  const int64_t bh = (int64_t)b * p.n_heads + h;
  float run[PER];
  int ent[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    ent[j] = blockIdx.x * WALK + j * THREADS + tid;
    run[j] = (p.dstate && ent[j] < NN) ? p.dstate[bh * NN + ent[j]] : 0.f;
  }
  for (int c0 = p.nch - 1; c0 >= 0; c0 -= BATCH) {
    float d[BATCH][PER], dc[BATCH][PER];
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = c0 - q;
        const bool in = c >= 0 && ent[j] < NN;
        d[q][j] = in ? p.dg[(bh * p.nch + c) * NN + ent[j]] : 0.f;
        dc[q][j] = in ? p.dec[(bh * p.nch + c) * N + ent[j] / N] : 0.f;
      }
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = c0 - q;
        if (c >= 0 && ent[j] < NN) {
          p.dg[(bh * p.nch + c) * NN + ent[j]] = run[j];
          run[j] = fmaf(dc[q][j], run[j], d[q][j]);
        }
      }
  }
  if (p.dstate0)
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (ent[j] < NN) p.dstate0[bh * NN + ent[j]] = run[j];
}

template <typename T>
__global__ void __launch_bounds__(GRAD_THREADS, 1)
wkv6_bwd_grad_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* rr = smem;                     // r, k, w, v, dy tiles
  float* kk = rr + TILE;
  float* ww = kk + TILE;
  float* vv = ww + TILE;
  float* dd = vv + TILE;
  float* gr = dd + TILE;                // dr, dk, dw tiles
  float* gk = gr + TILE;
  float* gw = gk + TILE;
  float* dvp = gw + TILE;               // [SUB][WARPS][NMAX] partial dv
  float* vy = dvp + SUB * WARPS * NMAX; // v_t . dy_t
  float* bon = vy + CH;                 // sum_n r_t u k_t
  float* us = bon + CH;

  const int tid = threadIdx.x, lane = tid % 32, wp = tid / 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, N = p.N;
  const int t0 = c * CH, L = min(CH, p.t_len - t0);
  const Strides& st = p.st;
  const int64_t bh = (int64_t)b * p.n_heads + h;
  constexpr int NT = GRAD_THREADS;
  load_tile<T, NT>(rr, static_cast<const T*>(p.r) + b * st.r[0] +
                   h * st.r[2], st.r[1], st.r[3], t0, L, N, p.vec & 1, tid);
  load_tile<T, NT>(kk, static_cast<const T*>(p.k) + b * st.k[0] +
                   h * st.k[2], st.k[1], st.k[3], t0, L, N, p.vec & 2, tid);
  load_tile<T, NT>(vv, static_cast<const T*>(p.v) + b * st.v[0] +
                   h * st.v[2], st.v[1], st.v[3], t0, L, N, p.vec & 4, tid);
  load_tile<T, NT>(ww, static_cast<const T*>(p.w) + b * st.w[0] +
                   h * st.w[2], st.w[1], st.w[3], t0, L, N, p.vec & 8, tid);
  load_tile<T, NT>(dd, static_cast<const T*>(p.dy) + b * st.dy[0] +
                   h * st.dy[2], st.dy[1], st.dy[3], t0, L, N, p.vec & 16,
                   tid);
  if (tid < NMAX) us[tid] = tid < N ? p.u[(int64_t)h * N + tid] : 0.f;
  __syncthreads();
  // v_t . dy_t and the bonus sum_n r u k a token, eight threads a token
  {
    const int i = tid / 8, part = tid % 8;
    float a = 0.f, d = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int n = part + 8 * j;
      a = fmaf(vv[i * NMAX + n], dd[i * NMAX + n], a);
      d = fmaf(rr[i * NMAX + n] * us[n], kk[i * NMAX + n], d);
    }
    a = row_sum(a);
    d = row_sum(d);
    if (part == 0) {
      vy[i] = a;
      bon[i] = d;
    }
  }
  __syncthreads();
  // the chunk's du, a channel a thread over the tokens in order
  if (tid < N) {
    float a = 0.f;
    for (int i = 0; i < L; ++i)
      a = fmaf(rr[i * NMAX + tid] * kk[i * NMAX + tid], vy[i], a);
    p.dup[(bh * p.nch + c) * N + tid] = a;
  }

  // thread (row n, eighth q): columns m0 .. m0 + 7 of row n
  const int n = tid / 8, q = tid % 8, m0 = COLS * q;
  const bool row_in = n < N;
  float g[COLS];                        // dS_t[n, m0 ..]
  {
    const float* gc = p.dg + (bh * p.nch + c) * N * N + (int64_t)n * N;
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      g[j] = row_in && m0 + j < N ? gc[m0 + j] : 0.f;
  }
  const float* s_row =
      p.starts ? p.starts + (bh * p.nch + c) * N * N + (int64_t)n * N
               : nullptr;
  const float un = us[n];
  // the reduce-scatter's columns: a warp's four rows summed, two columns
  // a lane
  const bool hi1 = lane & 8, hi2 = lane & 16;
  const int cb = m0 + (hi1 ? 4 : 0) + (hi2 ? 2 : 0);
  const int nsub = (L + SUB - 1) / SUB;
  for (int sc = nsub - 1; sc >= 0; --sc) {
    // S at the sub-chunk's start, from the chunk's start state
    float s[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      s[j] = s_row && row_in && m0 + j < N ? s_row[m0 + j] : 0.f;
    for (int i = 0; i < sc * SUB; ++i) {
      const float wn = ww[i * NMAX + n], kn = kk[i * NMAX + n];
      const float4 va = *reinterpret_cast<const float4*>(vv + i * NMAX + m0);
      const float4 vb =
          *reinterpret_cast<const float4*>(vv + i * NMAX + m0 + 4);
      const float vr[COLS] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[j] = fmaf(wn, s[j], kn * vr[j]);
    }
    // the sub-chunk's S_{t-1}, and dr on the way
    float hist[SUB][COLS];
#pragma unroll
    for (int jt = 0; jt < SUB; ++jt) {
      const int i = sc * SUB + jt;
#pragma unroll
      for (int j = 0; j < COLS; ++j) hist[jt][j] = s[j];
      if (i < L) {
        const float4 da = *reinterpret_cast<const float4*>(dd + i * NMAX + m0);
        const float4 db =
            *reinterpret_cast<const float4*>(dd + i * NMAX + m0 + 4);
        const float4 va = *reinterpret_cast<const float4*>(vv + i * NMAX + m0);
        const float4 vb =
            *reinterpret_cast<const float4*>(vv + i * NMAX + m0 + 4);
        const float dyr[COLS] = {da.x, da.y, da.z, da.w,
                                 db.x, db.y, db.z, db.w};
        const float vr[COLS] = {va.x, va.y, va.z, va.w,
                                vb.x, vb.y, vb.z, vb.w};
        const float wn = ww[i * NMAX + n], kn = kk[i * NMAX + n];
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          a = fmaf(s[j], dyr[j], a);
          s[j] = fmaf(wn, s[j], kn * vr[j]);
        }
        a = row_sum(a);
        if (q == 0) gr[i * NMAX + n] = fmaf(un * kn, vy[i], a);
      }
    }
    // the sub-chunk's tokens backwards: dk, dw, the rows' dv terms, dS
#pragma unroll
    for (int jt = SUB - 1; jt >= 0; --jt) {
      const int i = sc * SUB + jt;
      if (i < L) {
        const float4 da = *reinterpret_cast<const float4*>(dd + i * NMAX + m0);
        const float4 db =
            *reinterpret_cast<const float4*>(dd + i * NMAX + m0 + 4);
        const float4 va = *reinterpret_cast<const float4*>(vv + i * NMAX + m0);
        const float4 vb =
            *reinterpret_cast<const float4*>(vv + i * NMAX + m0 + 4);
        const float dyr[COLS] = {da.x, da.y, da.z, da.w,
                                 db.x, db.y, db.z, db.w};
        const float vr[COLS] = {va.x, va.y, va.z, va.w,
                                vb.x, vb.y, vb.z, vb.w};
        const float wn = ww[i * NMAX + n], kn = kk[i * NMAX + n],
                    rn = rr[i * NMAX + n];
        float ak = 0.f, aw = 0.f, x[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          ak = fmaf(g[j], vr[j], ak);
          aw = fmaf(g[j], hist[jt][j], aw);
          x[j] = g[j] * kn;
          g[j] = fmaf(wn, g[j], rn * dyr[j]);
        }
        ak = row_sum(ak);
        aw = row_sum(aw);
        if (q == 0) {
          gk[i * NMAX + n] = fmaf(un * rn, vy[i], ak);
          gw[i * NMAX + n] = aw;
        }
        // rows (0, 1) and (2, 3) of the warp, then (01, 23): each lane
        // keeps the half of its columns its partner does not
        float y[4], z[2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float got =
              __shfl_xor_sync(0xffffffffu, hi1 ? x[j] : x[4 + j], 8);
          y[j] = (hi1 ? x[4 + j] : x[j]) + got;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float got =
              __shfl_xor_sync(0xffffffffu, hi2 ? y[j] : y[2 + j], 16);
          z[j] = (hi2 ? y[2 + j] : y[j]) + got;
        }
        *reinterpret_cast<float2*>(dvp + (jt * WARPS + wp) * NMAX + cb) =
            make_float2(z[0], z[1]);
      }
    }
    __syncthreads();
    // dv of the sub-chunk's tokens: the 16 warps' sums in order, and the
    // bonus term
    {
      const int jt = tid / NMAX, m = tid % NMAX, i = sc * SUB + jt;
      if (i < L && m < N) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < WARPS; ++k) a += dvp[(jt * WARPS + k) * NMAX + m];
        a = fmaf(bon[i], dd[i * NMAX + m], a);
        static_cast<T*>(p.dv)[(((int64_t)b * p.t_len + t0 + i) * p.n_heads +
                               h) * N + m] = from_f32<T>(a);
      }
    }
    __syncthreads();
  }
  // dr, dk, dw of the chunk, a row of N a token
  for (int e = tid; e < L * N; e += NT) {
    const int i = e / N, m = e % N;
    const int64_t at = (((int64_t)b * p.t_len + t0 + i) * p.n_heads + h) * N
                       + m;
    static_cast<T*>(p.dr)[at] = from_f32<T>(gr[i * NMAX + m]);
    static_cast<T*>(p.dk)[at] = from_f32<T>(gk[i * NMAX + m]);
    static_cast<T*>(p.dw)[at] = from_f32<T>(gw[i * NMAX + m]);
  }
}

// du[h, n] = sum over batch rows and chunks, in order
__global__ void wkv6_bwd_du_kernel(const Params p, int batch) {
  const int h = blockIdx.x, n = threadIdx.x;
  if (n >= p.N) return;
  float a = 0.f;
  for (int b = 0; b < batch; ++b)
    for (int c = 0; c < p.nch; ++c)
      a += p.dup[(((int64_t)b * p.n_heads + h) * p.nch + c) * p.N + n];
  p.du[(int64_t)h * p.N + n] = a;
}

template <typename K>
cudaError_t smem_attr(K kernel, int floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(float) * floats));
}

template <typename T>
int launch(const Params& p, int b, cudaStream_t stream) {
  // once per instance and process (thread-safe static initialisers)
  static const cudaError_t a1 =
      smem_attr(wkv6_bwd_delta_kernel<T>, DELTA_FLOATS);
  static const cudaError_t a2 =
      smem_attr(wkv6_bwd_grad_kernel<T>, GRAD_FLOATS);
  if (a1 != cudaSuccess) return static_cast<int>(a1);
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  const dim3 chunks(p.nch, p.n_heads, b);
  wkv6_bwd_delta_kernel<T><<<chunks, THREADS, sizeof(float) * DELTA_FLOATS,
                             stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_walk_kernel<<<dim3((p.N * p.N + WALK - 1) / WALK, p.n_heads, b),
                         THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_grad_kernel<T><<<chunks, GRAD_THREADS,
                            sizeof(float) * GRAD_FLOATS, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_du_kernel<<<p.n_heads, NMAX, 0, stream>>>(p, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, dy and the four (B,T,H,N)
// gradients alike, the gradients contiguous). u (H,N), the states and du
// are contiguous fp32. starts (B,H,nch,N,N), nch = ceil(t_len / 64): each
// chunk's start state (the forward kernel's scratch after its walk); it
// may be null only when nch = 1, for a zero initial state. dstate may be
// null (zeros); dstate0 may be null (not wanted). Scratch: dg
// (B,H,nch,N,N), dec and dup (B,H,nch,N) fp32. vec: bits 0..4 set when r,
// k, v, w, dy rows may be read 16 bytes at a time. strides: 20 int64
// element strides, (b, t, h, n) of r, k, v, w and dy. Requires b, t_len,
// n_heads >= 1, b <= 65535, n_heads <= 65535 and 1 <= N <= 64 (the wrapper
// checks). Returns cudaGetLastError() after the launches.
extern "C" int repro_wkv6_bwd(int dtype, const void* r, const void* k,
                              const void* v, const void* w, const void* dy,
                              const void* u, const void* starts,
                              const void* dstate, void* dstate0, void* dr,
                              void* dk, void* dv, void* dw, void* du,
                              void* dg, void* dec, void* dup, int b,
                              int t_len, int n_heads, int N, int vec,
                              const void* strides, void* stream) {
  const int nch = (t_len + CH - 1) / CH;
  if (b < 1 || t_len < 1 || n_heads < 1 || N < 1 || N > NMAX ||
      b > 65535 || n_heads > 65535 || (nch > 1 && !starts) || !dg || !dec ||
      !dup)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{r, k, v, w, dy, static_cast<const float*>(u),
           static_cast<const float*>(starts),
           static_cast<const float*>(dstate), static_cast<float*>(dstate0),
           dr, dk, dv, dw, static_cast<float*>(du), static_cast<float*>(dg),
           static_cast<float*>(dec), static_cast<float*>(dup), t_len,
           n_heads, N, nch, vec, {}};
  const int64_t* s = static_cast<const int64_t*>(strides);
  for (int i = 0; i < 4; ++i) {
    p.st.r[i] = s[i];
    p.st.k[i] = s[4 + i];
    p.st.v[i] = s[8 + i];
    p.st.w[i] = s[12 + i];
    p.st.dy[i] = s[16 + i];
  }
  auto str = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, b, str);
  if (dtype == 1) return launch<__nv_bfloat16>(p, b, str);
  return static_cast<int>(cudaErrorInvalidValue);
}
