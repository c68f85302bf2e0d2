// Backward of the forward online-softmax attention (flash_attention.cu):
// the FlashAttention-2 gradient, recomputed from the forward's logsumexp.
//
// Replaces no Pallas kernel: the JAX package's Pallas attention is forward
// only (src/repro/kernels/flash_attention/ops.py:4), and JAX differentiates
// its jnp paths. The port's plain version serves CPU tensors only, so
// training on the card takes this kernel; it computes the gradient of what
// flash_attention (src/repro/kernels/flash_attention/flash_attention.py:73)
// computes: q (B,T,H,dq), k (B,S,Hkv,dq), v (B,S,Hkv,dv), fp32 or bf16,
// read through their strides, GQA (query head h reads kv head
// h / (H / Hkv)), causal with right-aligned queries (query row t sits at
// position t + S - T and sees keys <= it), an optional window (keys
// > position - window), dq != dv, head dims up to 256.
//
// Three launches on the caller's stream:
//   bwd_delta: D = rowsum(dO * O) for each (b, h, t), fp32, one warp a row;
//   bwd_dkdv:  one block a (32-key tile, kv head, batch row). K and V of
//     the tile stay in shared memory; the block walks the g query heads of
//     its kv head and the 32-row query tiles that can see the tile (the
//     causal and window masks bound them), recomputes S = scale Q K^T and
//     P = exp(S - lse), and accumulates dV += P^T dO and dK += scale dS^T Q
//     with dP = dO V^T, dS = P (dP - D). The sum over the group is inside
//     the block: no atomics, deterministic;
//   bwd_dq:    one block a (32-row query tile, head, batch row), walking
//     the key tiles that the masks leave it: dQ += scale dS K.
// Masked entries (and keys past S, rows past T) take P = 0, so a row with
// no valid key gets zero gradients and no NaN (the plain version,
// ref.attention_bwd, does the same).
//
// Arithmetic: fp32 throughout on the CUDA cores (bf16 inputs are widened
// as they are staged), tiles in shared memory as fp32, 256 threads a
// block; each thread owns 4 entries of the 32 x 32 logit tile and a
// (row, 4 columns every 32) slice of the accumulators, reading float4 rows
// whose pitch (dim + 4 words) keeps the 8 lanes of a phase on distinct
// banks. Head dims are compile-time: both padded to the larger one's 64,
// 128 or 256, or 256 / 128 for MLA's dq 192 against dv 128 (four
// instances a kernel; zeros in shared memory).
//
// Bound on an H100 at 700 W: the gradient needs 5 products of T S d
// (2.5 times the forward's 2; half under the causal mask) against the
// bytes of q, k, v, o, dO, dq, dk, dv. This kernel spends 7 (S and dP are
// recomputed by both the dK/dV and the dQ pass) on the CUDA cores, not
// the tensor cores: a first version that is right, whose speed is later
// work (mma.sync or wgmma on bf16 tiles, one pass with dQ kept in fp32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 32;          // query rows and keys of a tile
constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// element strides (b, t, h, d) of q, k, v, o, dO, dq, dk, dv
struct Strides4 {
  int64_t b, t, h, d;
};

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, H, T) natural-log logsumexp of the scaled logits
  float* delta;       // (B, H, T) scratch: rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  int t_len, s_len, n_heads, n_kv, dq_dim, dv_dim;
  float scale;
  int causal, use_window, window, bf16_in;
  Strides4 sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

__device__ __forceinline__ float ld(const void* p, int64_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void st(void* p, int64_t i, float x, int is_bf16) {
  if (is_bf16)
    static_cast<bf16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// rows [r0, r0 + TILE) of a (len, d) slice at base (row stride sr, element
// stride sd) into dst (TILE x ld) as fp32, columns [0, DPAD): zero past d
// and past len
template <int DPAD>
__device__ __forceinline__ void stage(float* dst, int ld_, const void* base,
                                      int64_t off, int64_t sr, int64_t sd,
                                      int r0, int len, int d, int is_bf16,
                                      int tid) {
#pragma unroll 4
  for (int e = tid; e < TILE * DPAD; e += THREADS) {
    const int r = e / DPAD, c = e % DPAD;
    const int row = r0 + r;
    dst[r * ld_ + c] = (row < len && c < d)
                           ? ld(base, off + row * sr + c * sd, is_bf16)
                           : 0.f;
  }
}

__device__ __forceinline__ bool visible(int key, int pos, const BwdParams& p) {
  return key < p.s_len && (!p.causal || key <= pos) &&
         (!p.use_window || key > pos - p.window);
}

// acc[c] (4 entries) = sum_d a[d] * b_c[d] over the padded dim, a row i of
// A and rows j0 + 8 c of B (both fp32 in shared memory, pitch ld_)
template <int D>
__device__ __forceinline__ void dot4(float (&acc)[4], const float* a,
                                     const float* b, int ld_) {
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 y = *reinterpret_cast<const float4*>(b + 8 * c * ld_ + d);
      acc[c] = fmaf(x.x, y.x, acc[c]);
      acc[c] = fmaf(x.y, y.y, acc[c]);
      acc[c] = fmaf(x.z, y.z, acc[c]);
      acc[c] = fmaf(x.w, y.w, acc[c]);
    }
  }
}

// out[m] (float4 columns 32 m + 4 lane8) += sum_r w[r * lw] * src[r][cols]
// over the TILE rows r of src (pitch ls)
template <int D>
__device__ __forceinline__ void axpy_rows(float4 (&out)[D / 32],
                                          const float* w, int lw,
                                          const float* src, int ls,
                                          int lane8) {
#pragma unroll 4
  for (int r = 0; r < TILE; ++r) {
    const float a = w[r * lw];
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      const float4 y =
          *reinterpret_cast<const float4*>(src + r * ls + 32 * m + 4 * lane8);
      out[m].x = fmaf(a, y.x, out[m].x);
      out[m].y = fmaf(a, y.y, out[m].y);
      out[m].z = fmaf(a, y.z, out[m].z);
      out[m].w = fmaf(a, y.w, out[m].w);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_row(void* base, int64_t off,
                                          int64_t sd, int d,
                                          const float4 (&acc)[D / 32],
                                          float mul, int lane8, int is_bf16) {
#pragma unroll
  for (int m = 0; m < D / 32; ++m) {
    const int c = 32 * m + 4 * lane8;
    const float v4[4] = {acc[m].x, acc[m].y, acc[m].z, acc[m].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < d) st(base, off + (c + e) * sd, mul * v4[e], is_bf16);
  }
}

// --------------------------------------------------------------- delta --

__global__ void __launch_bounds__(THREADS) bwd_delta(BwdParams p, int b_n) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int rows = b_n * p.n_heads * p.t_len;
  if (row >= rows) return;
  const int t = row % p.t_len;
  const int h = (row / p.t_len) % p.n_heads;
  const int b = row / (p.t_len * p.n_heads);
  const int64_t oo = b * p.so.b + t * p.so.t + h * p.so.h;
  const int64_t od = b * p.sdo.b + t * p.sdo.t + h * p.sdo.h;
  float s = 0.f;
  for (int c = lane; c < p.dv_dim; c += 32)
    s = fmaf(ld(p.o, oo + c * p.so.d, p.bf16_in),
             ld(p.dout, od + c * p.sdo.d, p.bf16_in), s);
#pragma unroll
  for (int sh = 16; sh; sh >>= 1) s += __shfl_xor_sync(0xffffffffu, s, sh);
  if (lane == 0) p.delta[row] = s;
}

// ------------------------------------------------------- shared layout --

template <int DQ, int DV>
struct Shape {
  static constexpr int LQ = DQ + 4, LV = DV + 4, LP = TILE + 1;
  // two (TILE, LQ) and two (TILE, LV) tiles, P and dS, lse and delta
  static constexpr size_t SMEM =
      sizeof(float) * (2 * TILE * LQ + 2 * TILE * LV + 2 * TILE * LP +
                       2 * TILE);
  static_assert(SMEM <= SMEM_MAX, "tiles fit");
};

// S and dP of a (query tile, key tile) pair into ps / dss as P and dS:
// thread (i = tid / 8, j = tid % 8 + 8 c). qs/ks (pitch LQ), dos/vs
// (pitch LV); lse_s, del_s per query row (lse in log2 units). q0: the
// query tile's first row, k0: the key tile's first key.
template <int DQ, int DV>
__device__ __forceinline__ void p_ds(const BwdParams& p, const float* qs,
                                     const float* ks, const float* dos,
                                     const float* vs, const float* lse_s,
                                     const float* del_s, float* ps,
                                     float* dss, int q0, int k0, int tid) {
  using Sh = Shape<DQ, DV>;
  const int i = tid >> 3, j0 = tid & 7;
  float s[4], dp[4];
  dot4<DQ>(s, qs + i * Sh::LQ, ks + j0 * Sh::LQ, Sh::LQ);
  dot4<DV>(dp, dos + i * Sh::LV, vs + j0 * Sh::LV, Sh::LV);
  const int t = q0 + i;
  const int pos = t + p.s_len - p.t_len;
  const float sl2 = p.scale * LOG2E;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + 8 * c;
    const bool on = t < p.t_len && visible(k0 + j, pos, p);
    const float pr = on ? exp2f(s[c] * sl2 - lse_s[i]) : 0.f;
    ps[i * Sh::LP + j] = pr;
    dss[i * Sh::LP + j] = pr * (dp[c] - del_s[i]);
  }
}

// ---------------------------------------------------------------- dK dV --

template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dkdv(BwdParams p) {
  using Sh = Shape<DQ, DV>;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                         // (TILE, LQ)
  float* vs = ks + TILE * Sh::LQ;         // (TILE, LV)
  float* qs = vs + TILE * Sh::LV;         // (TILE, LQ)
  float* dos = qs + TILE * Sh::LQ;        // (TILE, LV)
  float* ps = dos + TILE * Sh::LV;        // (TILE, LP)
  float* dss = ps + TILE * Sh::LP;        // (TILE, LP)
  float* lse_s = dss + TILE * Sh::LP;     // (TILE)
  float* del_s = lse_s + TILE;            // (TILE)

  const int tid = threadIdx.x, lane8 = tid & 7, jrow = tid >> 3;
  const int k0 = blockIdx.x * TILE;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = p.n_heads / p.n_kv;
  const int off = p.s_len - p.t_len;
  const int bi = p.bf16_in;

  stage<DQ>(ks, Sh::LQ, p.k, b * p.sk.b + hk * p.sk.h, p.sk.t, p.sk.d, k0,
            p.s_len, p.dq_dim, bi, tid);
  stage<DV>(vs, Sh::LV, p.v, b * p.sv.b + hk * p.sv.h, p.sv.t, p.sv.d, k0,
            p.s_len, p.dv_dim, bi, tid);

  // query rows that can see some key of [k0, k1): causal pos >= k0,
  // window pos < k1 - 1 + window
  const int k1 = min(k0 + TILE, p.s_len);
  int t_lo = 0, t_hi = p.t_len;
  if (p.causal) t_lo = max(0, k0 - off);
  if (p.use_window) t_hi = min(p.t_len, k1 - 1 + p.window - off);

  float4 dk[DQ / 32], dv[DV / 32];
#pragma unroll
  for (int m = 0; m < DQ / 32; ++m) dk[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int m = 0; m < DV / 32; ++m) dv[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int hq = 0; hq < g; ++hq) {
    const int h = hk * g + hq;
    const float* lse = p.lse + (static_cast<int64_t>(b) * p.n_heads + h) *
                                   p.t_len;
    const float* del = p.delta + (static_cast<int64_t>(b) * p.n_heads + h) *
                                     p.t_len;
    for (int q0 = (t_lo / TILE) * TILE; q0 < t_hi; q0 += TILE) {
      __syncthreads();   // the previous tile's Q, dO, P, dS are consumed
      stage<DQ>(qs, Sh::LQ, p.q, b * p.sq.b + h * p.sq.h, p.sq.t, p.sq.d,
                q0, p.t_len, p.dq_dim, bi, tid);
      stage<DV>(dos, Sh::LV, p.dout, b * p.sdo.b + h * p.sdo.h, p.sdo.t,
                p.sdo.d, q0, p.t_len, p.dv_dim, bi, tid);
      if (tid < TILE) {
        const int t = q0 + tid;
        lse_s[tid] = t < p.t_len ? lse[t] * LOG2E : 0.f;
        del_s[tid] = t < p.t_len ? del[t] : 0.f;
      }
      __syncthreads();
      p_ds<DQ, DV>(p, qs, ks, dos, vs, lse_s, del_s, ps, dss, q0, k0, tid);
      __syncthreads();
      // thread: key row jrow; dV[jrow] += sum_i P[i][jrow] dO[i],
      // dK[jrow] += sum_i dS[i][jrow] Q[i]
      axpy_rows<DV>(dv, ps + jrow, Sh::LP, dos, Sh::LV, lane8);
      axpy_rows<DQ>(dk, dss + jrow, Sh::LP, qs, Sh::LQ, lane8);
    }
  }
  const int key = k0 + jrow;
  if (key >= p.s_len) return;
  store_row<DQ>(p.dk, b * p.sdk.b + key * p.sdk.t + hk * p.sdk.h, p.sdk.d,
                p.dq_dim, dk, p.scale, lane8, bi);
  store_row<DV>(p.dv, b * p.sdv.b + key * p.sdv.t + hk * p.sdv.h, p.sdv.d,
                p.dv_dim, dv, 1.f, lane8, bi);
}

// ------------------------------------------------------------------ dQ --

template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dq(BwdParams p) {
  using Sh = Shape<DQ, DV>;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                         // (TILE, LQ)
  float* dos = qs + TILE * Sh::LQ;        // (TILE, LV)
  float* ks = dos + TILE * Sh::LV;        // (TILE, LQ)
  float* vs = ks + TILE * Sh::LQ;         // (TILE, LV)
  float* ps = vs + TILE * Sh::LV;         // (TILE, LP)
  float* dss = ps + TILE * Sh::LP;        // (TILE, LP)
  float* lse_s = dss + TILE * Sh::LP;     // (TILE)
  float* del_s = lse_s + TILE;            // (TILE)

  const int tid = threadIdx.x, lane8 = tid & 7, irow = tid >> 3;
  // heaviest causal tiles first
  const int qtile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qtile * TILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.n_heads / p.n_kv);
  const int off = p.s_len - p.t_len;
  const int bi = p.bf16_in;

  stage<DQ>(qs, Sh::LQ, p.q, b * p.sq.b + h * p.sq.h, p.sq.t, p.sq.d, q0,
            p.t_len, p.dq_dim, bi, tid);
  stage<DV>(dos, Sh::LV, p.dout, b * p.sdo.b + h * p.sdo.h, p.sdo.t,
            p.sdo.d, q0, p.t_len, p.dv_dim, bi, tid);
  if (tid < TILE) {
    const int t = q0 + tid;
    const int64_t r = (static_cast<int64_t>(b) * p.n_heads + h) * p.t_len + t;
    lse_s[tid] = t < p.t_len ? p.lse[r] * LOG2E : 0.f;
    del_s[tid] = t < p.t_len ? p.delta[r] : 0.f;
  }

  // the key tiles some row of [q0, q1) may see
  const int nkv = (p.s_len + TILE - 1) / TILE;
  const int pos_lo = q0 + off, pos_hi = min(q0 + TILE, p.t_len) - 1 + off;
  int j_lo = 0, j_hi = nkv;
  if (p.causal) j_hi = pos_hi < 0 ? 0 : min(nkv, pos_hi / TILE + 1);
  if (p.use_window) {
    const int e = pos_lo - p.window;     // first key > e
    j_lo = e < 0 ? 0 : (e + 1 >= p.s_len ? nkv : (e + 1) / TILE);
  }

  float4 acc[DQ / 32];
#pragma unroll
  for (int m = 0; m < DQ / 32; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int jt = j_lo; jt < j_hi; ++jt) {
    const int k0 = jt * TILE;
    __syncthreads();   // the previous tile's K, V, P, dS are consumed
    stage<DQ>(ks, Sh::LQ, p.k, b * p.sk.b + hk * p.sk.h, p.sk.t, p.sk.d, k0,
              p.s_len, p.dq_dim, bi, tid);
    stage<DV>(vs, Sh::LV, p.v, b * p.sv.b + hk * p.sv.h, p.sv.t, p.sv.d, k0,
              p.s_len, p.dv_dim, bi, tid);
    __syncthreads();
    p_ds<DQ, DV>(p, qs, ks, dos, vs, lse_s, del_s, ps, dss, q0, k0, tid);
    __syncthreads();
    // thread: query row irow; dQ[irow] += sum_j dS[irow][j] K[j]
    axpy_rows<DQ>(acc, dss + irow * Sh::LP, 1, ks, Sh::LQ, lane8);
  }
  const int t = q0 + irow;
  if (t >= p.t_len) return;
  store_row<DQ>(p.dq, b * p.sdq.b + t * p.sdq.t + h * p.sdq.h, p.sdq.d,
                p.dq_dim, acc, p.scale, lane8, bi);
}

template <typename K>
int launch(K kernel, size_t smem, dim3 grid, const BwdParams& p,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DQ, int DV>
int launch_dims(int b, const BwdParams& p, cudaStream_t s) {
  const size_t smem = Shape<DQ, DV>::SMEM;
  int err = launch(bwd_dkdv<DQ, DV>, smem,
                   dim3((p.s_len + TILE - 1) / TILE, p.n_kv, b), p, s);
  if (err) return err;
  return launch(bwd_dq<DQ, DV>, smem,
                dim3((p.t_len + TILE - 1) / TILE, p.n_heads, b), p, s);
}


Strides4 strides4(const int64_t* s) { return Strides4{s[0], s[1], s[2], s[3]}; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dO, dq, dk, dv alike.
// lse: (B, H, T) fp32 natural-log logsumexp of the scaled logits (the
// forward kernel's); delta: (B, H, T) fp32 scratch. strides: 32 int64
// element strides, (b, t, h, d) of q, k, v, o, dO, dq, dk, dv in that
// order. Requires 1 <= dq, dv <= 256 and n_heads % n_kv == 0 (the wrapper
// checks). Three launches (delta, dK/dV, dQ); returns cudaGetLastError()
// after the last, or the first launch's error.
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int t_len, int s_len, int n_heads, int n_kv, int dq_dim,
    int dv_dim, float scale, int causal, int use_window, int window,
    const void* strides, void* stream) {
  if (dq_dim > 256 || dv_dim > 256 || dq_dim < 1 || dv_dim < 1 ||
      n_kv < 1 || n_heads % n_kv != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = static_cast<const int64_t*>(strides);
  BwdParams p{q,      k,      v,       o,       dout,
              lse,    delta,  dq,      dk,      dv,
              t_len,  s_len,  n_heads, n_kv,    dq_dim,
              dv_dim, scale,  causal,  use_window, window,
              dtype,  strides4(s), strides4(s + 4), strides4(s + 8),
              strides4(s + 12), strides4(s + 16), strides4(s + 20),
              strides4(s + 24), strides4(s + 28)};
  auto str = static_cast<cudaStream_t>(stream);
  const int rows = b * n_heads * t_len;
  const int per = THREADS / 32;
  bwd_delta<<<(rows + per - 1) / per, THREADS, 0, str>>>(p, b);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // four instances: both dims padded to the larger one's 64 / 128 / 256
  // rounding, and MLA's (dq 192, dv 128) as 256 / 128
  const int dmax = dq_dim > dv_dim ? dq_dim : dv_dim;
  if (dmax <= 64) return launch_dims<64, 64>(b, p, str);
  if (dmax <= 128) return launch_dims<128, 128>(b, p, str);
  if (dv_dim <= 128) return launch_dims<256, 128>(b, p, str);
  return launch_dims<256, 256>(b, p, str);
}
