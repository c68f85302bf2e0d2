// Forward online-softmax attention for Hopper: a tensor-core kernel for
// bf16 and a CUDA-core kernel for fp32.
//
// Replaces the Pallas TPU kernel flash_attention (_flash_kernel,
// src/repro/kernels/flash_attention/flash_attention.py:26, reached through
// pl.pallas_call at :94 from flash_attention at :73). Inputs q (B,T,H,dq),
// k (B,S,Hkv,dq), v (B,S,Hkv,dv) are read through their strides (no
// transposes, no copies); the output o (B,T,H,dv) has q's dtype. Query head
// h reads kv head h / (H / Hkv) (GQA). Masks: causal with right-aligned
// queries (query row t sits at absolute position t + S - T), an optional
// sliding window, or none. Masked logits are -1e30 and the denominator is
// floored at 1e-30, exactly as flash_attention.py:53,67; keys past the
// ragged end of S get zero weight, and query rows past T are not written.
// Both kernels compute the softmax in base 2, with scale * log2(e) folded
// into the logits.
// Given an lse buffer (training: the autograd Function of ops.py), each
// kernel also writes every query row's natural-log logsumexp, (m +
// log2 l) ln 2, which the backward (flash_attention_bwd.cu) recomputes P
// from; a null buffer leaves inference as it was.
//
// Bounds on an H100 at 700 W, at the shapes the port's paths give it:
//   DeiT-Base, B = 16, T = S = 197, H = 12, d = 64, fp32: 2 B H T S (dq + dv)
//   = 1.9 GFLOP against 39 MB, bound by operations on the CUDA cores
//   (67 TFLOP/s: 28 us).
//   Qwen2-1.5B prefill, B = 1, T = S = 512, causal, GQA 12/2, d = 128, bf16:
//   0.81 GFLOP on the tensor cores (0.8 us at 989 TFLOP/s) against 3.7 MB
//   (1.1 us at 3.35 TB/s), bound by bytes; in practice by the latency of
//   the longest causal query tile (8 kv tiles on one SM).
//
// bf16, flash_fwd_bf16 (FlashAttention-2 structure): Q K^T and P V run on
// the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32 accumulate), with
// operands brought from shared memory by ldmatrix (ldmatrix.trans for V).
// A block of 8 warps owns a 64-row query tile: warp w holds rows
// 16 (w % 4) .. + 16 and every other kv tile of the block's range (w / 4
// picks which), so the longest causal tile walks its 8 kv tiles of the
// Qwen2 prefill in 4 steps; the two halves merge their (max, sum,
// accumulator) through shared memory at the end. The running max, the
// per-thread partial sums and the (16, dv) O accumulator stay in
// registers; row reductions are quad shuffles. P goes from the S
// accumulator fragment straight into the A fragment of the P V product,
// rounded to bf16 (the Pallas kernel multiplies P V in fp32: a deliberate
// difference, inside the bf16 gate). K/V tiles of 64 rows move through a
// ring of 4 stages (the pair being computed, the next pair in flight) of
// 16-byte cp.async copies, one __syncthreads a pair; rows past S are
// zero-filled. Head dims are compile-time (dq padded to 32, 64, 128 or
// 256, dv to 64, 128 or 256, zeros in shared memory), so no loop over them
// branches and ptxas can overlap the ldmatrix loads with the products; rows
// are padded by 16 bytes so that ldmatrix is free of bank conflicts.
// Head dims above 128 (gemma3's 256): the ring of four 64-key stages would
// not fit a block's 227 KB (at dq = dv = 256 it is 270 KB), so a shape
// whose four stages do not fit keeps one pair of stages and loads the next
// pair after the current one is computed (no overlap of load and compute);
// dq = 128 with dv = 256 still fits four. Above 128 the Q fragments are
// read from shared memory for every kv tile instead of being held in
// registers, which leaves the 128 registers of a 256-wide O accumulator
// within the 255 a thread may have.
//
// fp32, flash_fwd_f32: no tensor cores (TF32 would break the 1e-4 gate). A
// block of 8 warps owns a 64-row query tile, each warp 8 rows, so that at
// T = 197 the last tile (5 rows) costs one warp of eight. Q, K and V are
// staged row-major by a two-stage cp.async ring, one __syncthreads a tile.
// Each lane owns a 4 x 4 logit micro-tile (4 rows, keys lane + 16 j) and
// reads Q and K as float4 along d (K's row pitch keeps the 8 lanes of a
// phase on distinct banks); the softmax runs in registers with 16-lane
// shuffles; P goes through a per-warp 64 x 8 buffer (no block barrier),
// and each lane owns a 4-row by (4 columns every 64) micro-tile of O,
// reading V as float4. Head dims are compile-time as in the bf16 kernel.
// A shape whose two stages do not fit (any head dim above 128) runs one
// stage: the next tile loads after the current one is computed.
//
// Both: query tiles are scheduled heaviest first under the causal mask
// (reverse blockIdx.x); kv tiles that the causal or window mask hides from
// every row of the block are skipped (ops.py:112-118), a warp skips those it
// hides from all of its rows and those of a warp whose rows all lie past T,
// and the mask is evaluated only on tiles that cross the diagonal, the
// window edge or the end of S. Inputs whose last stride is not 1 or whose
// rows are not 16-byte aligned are loaded element by element by the same
// kernels (a flag per tensor from the wrapper). Next step where the bf16
// kernel still loses to SDPA: wgmma on TMA-loaded tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

constexpr int BQ = 64;            // query rows of a block
constexpr int BKV = 64;           // keys of a kv tile
constexpr int DMAX = 256;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  int64_t qb, qt, qh, qd, kb, kt, kh, kd, vb, vt, vh, vd, ob, ot, oh, od;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // (B, H, T) natural-log logsumexp of each row, or null
  int t_len, s_len, n_heads, n_kv, dq, dv;
  float scale_log2;
  int causal, use_window, window, vec;
  Strides st;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// The kv tiles [begin, end) that some row of query positions
// [pos_lo, pos_hi] may see; tiles outside hold only masked keys.
struct KvRange {
  int begin, end;
};
__device__ __forceinline__ KvRange kv_range(int pos_lo, int pos_hi,
                                            int s_len, int causal,
                                            int use_window, int window) {
  const int nkv = (s_len + BKV - 1) / BKV;
  KvRange r{0, nkv};
  if (causal) r.end = pos_hi < 0 ? 0 : min(nkv, pos_hi / BKV + 1);
  if (use_window) {                  // first tile holding a key > e
    const int e = pos_lo - window;
    r.begin = e < 0 ? 0 : (e + 1 >= s_len ? nkv : (e + 1) / BKV);
  }
  return r;
}

// ---------------------------------------------------------------- bf16 --

// 8 warps: warp w owns query rows 16 (w % 4) .. + 16 of the block's 64 and
// every other kv tile (w / 4 picks which), so that the longest causal
// block walks its kv range in half the steps; the two halves merge at the
// end.
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;

// DQ, DV: the head dims rounded up to 32/64/128 (64/128 for dv); shared
// memory holds zeros past the real dims, so every loop has a fixed count.
// Rows are padded by 16 bytes: ldmatrix's 8 rows fall on distinct banks.
// The ring holds two pairs of kv tiles (one pair computed, one loading)
// where they fit, else one pair. QREG: Q's fragments stay in registers.
template <int DQ, int DV>
struct TcShape {
  static constexpr int LDQ = DQ + 8, LDV = DV + 8;
  static constexpr int STAGE = BKV * (LDQ + LDV);
  static constexpr int PAIRS =
      sizeof(bf16) * (BQ * LDQ + 4 * STAGE) <= SMEM_MAX ? 2 : 1;
  static constexpr size_t SMEM = sizeof(bf16) * (BQ * LDQ + 2 * PAIRS * STAGE);
  static constexpr bool QREG = DQ <= 128 && DV <= 128;
  static_assert(SMEM <= SMEM_MAX, "one pair of stages fits");
  // the merge of the two kv halves reuses the ring: per thread DV / 2
  // accumulators, two maxima and two partial sums
  static_assert(4 * 32 * (DV / 2 + 4) * sizeof(float) <=
                    2 * PAIRS * STAGE * sizeof(bf16), "merge fits the ring");
};

template <int DQ, int DV>
__global__ void __launch_bounds__(TC_THREADS) flash_fwd_bf16(Params p) {
  using Sh = TcShape<DQ, DV>;
  constexpr int LDQ = Sh::LDQ, LDV = Sh::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);        // (BQ, LDQ)
  bf16* ring = qs + BQ * LDQ;  // 2 PAIRS stages of K (BKV, LDQ), V (BKV, LDV)
  const Strides& st = p.st;
  const int t_len = p.t_len, s_len = p.s_len;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, half = warp >> 2;           // row group, kv half
  const int g = lane >> 2, tq = lane & 3;              // mma fragment coords
  const int qtile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qtile * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.n_heads / p.n_kv);
  const int off = s_len - t_len;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * st.qb + h * st.qh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * st.kb + hk * st.kh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * st.vb + hk * st.vh;

  const KvRange blk = kv_range(q0 + off, min(q0 + BQ, t_len) - 1 + off,
                               s_len, p.causal, p.use_window, p.window);
  // this warp's rows: [w0, w0 + 16) of the query axis
  const int w0 = q0 + 16 * rg;
  const bool active = w0 < t_len;
  const int wpos_lo = w0 + off, wpos_hi = min(w0 + 16, t_len) - 1 + off;
  // a warp may skip a tile only when each of its rows sees some key
  // elsewhere (its own position): then the skipped keys weigh exactly 0
  const KvRange wr = wpos_lo >= 0 ? kv_range(wpos_lo, wpos_hi, s_len,
                                             p.causal, p.use_window, p.window)
                                  : blk;

  // pair i of the block's kv tiles (blk.begin + 2 i, + 1) into stages
  // 2 (i % 2) and 2 (i % 2) + 1 (one pair of stages: 0 and 1)
  auto stage_of = [](int i, int e) {
    return (Sh::PAIRS == 2 ? 2 * (i & 1) : 0) + e;
  };
  auto issue = [&](int i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = blk.begin + 2 * i + e;
      if (j >= blk.end) break;
      bf16* dst = ring + stage_of(i, e) * Sh::STAGE;
      load_tile<bf16, BKV, TC_THREADS, DQ>(dst, LDQ, kp, st.kt, st.kd,
                                           j * BKV, s_len, p.dq, p.vec & 2,
                                           tid);
      load_tile<bf16, BKV, TC_THREADS, DV>(dst + BKV * LDQ, LDV, vp, st.vt,
                                           st.vd, j * BKV, s_len, p.dv,
                                           p.vec & 4, tid);
    }
  };
  load_tile<bf16, BQ, TC_THREADS, DQ>(qs, LDQ, qp, st.qt, st.qd, q0, t_len,
                                      p.dq, p.vec & 1, tid);
  issue(0);
  cp_async_commit();

  uint32_t qf[Sh::QREG ? DQ / 16 : 1][4];
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};   // rows g and g + 8 of the warp
  float l_r[2] = {0.f, 0.f};           // this thread's part of the sums
  const int mi = lane >> 3;     // the ldmatrix matrix this lane addresses

  const int pairs = (blk.end - blk.begin + 1) / 2;
  for (int i = 0; i < pairs; ++i) {
    if (Sh::PAIRS == 1 && i > 0) {
      __syncthreads();   // every warp is done with pair i - 1: load pair i
      issue(i);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();   // pair i is in; every warp is done with pair i - 1
    if constexpr (Sh::QREG) {
      if (i == 0 && active) {
#pragma unroll
        for (int kk = 0; kk < DQ / 16; ++kk)
          ldmatrix_x4(qf[kk], qs + (16 * rg + (lane & 15)) * LDQ + kk * 16 +
                                  ((lane >> 4) << 3));
      }
    }
    if (Sh::PAIRS == 2) {
      if (i + 1 < pairs) issue(i + 1);
      cp_async_commit();
    }
    const int j = blk.begin + 2 * i + half;
    if (!active || j >= blk.end || j < wr.begin || j >= wr.end) continue;

    const bf16* ks = ring + stage_of(i, half) * Sh::STAGE;
    const bf16* vs = ks + BKV * LDQ;
    const int k0 = j * BKV;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (Sh::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, qs + (16 * rg + (lane & 15)) * LDQ + kk * 16 +
                            ((lane >> 4) << 3));
      }
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (n2 * 16 + ((mi >> 1) << 3) + (lane & 7)) * LDQ +
                            kk * 16 + ((mi & 1) << 3));
        mma_bf16(s[2 * n2], qa, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], qa, bk[2], bk[3]);
      }
    }

    const bool need_mask = k0 + BKV > s_len ||
                           (p.causal && k0 + BKV - 1 > wpos_lo) ||
                           (p.use_window && k0 <= wpos_hi - p.window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale_log2;
        if (need_mask) {
          const int key = k0 + n * 8 + 2 * tq + (e & 1);
          const int pos = w0 + g + ((e >> 1) << 3) + off;
          if (key >= s_len)
            x = -INFINITY;                        // not a key: no weight
          else if ((p.causal && key > pos) ||
                   (p.use_window && key <= pos - p.window))
            x = NEG_INF;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - m_r[e >> 1]);
        s[n][e] = pe;
        l_r[e >> 1] += pe;
      }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {           // 16 keys at a time
      uint32_t pa[4];
      acc_to_a(pa, s, kk);
#pragma unroll
      for (int n2 = 0; n2 < DV / 16; ++n2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + ((mi & 1) << 3) + (lane & 7)) *
                                       LDV + n2 * 16 + ((mi >> 1) << 3));
        mma_bf16(acc[2 * n2], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * n2 + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // merge the odd tiles' half into the even tiles' half, row by row:
  // m = max(m0, m1), each side rescaled by exp2(m_side - m)
  cp_async_wait_all();   // nothing left in flight when no tile ran
  __syncthreads();       // the ring is free
  float* xchg = reinterpret_cast<float*>(ring) + (rg * 32 + lane);
  constexpr int XS = 4 * 32;            // stride between a thread's values
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xchg[(4 * n + e) * XS] = acc[n][e];
    xchg[(DV / 2) * XS] = m_r[0];
    xchg[(DV / 2 + 1) * XS] = m_r[1];
    xchg[(DV / 2 + 2) * XS] = l_r[0];
    xchg[(DV / 2 + 3) * XS] = l_r[1];
  }
  __syncthreads();
  if (half == 1 || !active) return;
  float c0[2], c1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xchg[(DV / 2 + r) * XS];
    const float m = fmaxf(m_r[r], m1);
    c0[r] = exp2f(m_r[r] - m);
    c1[r] = exp2f(m1 - m);
    l_r[r] = l_r[r] * c0[r] + xchg[(DV / 2 + 2 + r) * XS] * c1[r];
    m_r[r] = m;
  }
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = acc[n][e] * c0[e >> 1] + xchg[(4 * n + e) * XS] * c1[e >> 1];

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = w0 + g + 8 * r;
    if (row >= t_len) continue;
    const float denom = fmaxf(l, 1e-30f);
    if (p.lse != nullptr && tq == 0)
      p.lse[(static_cast<int64_t>(b) * p.n_heads + h) * t_len + row] =
          (m_r[r] + log2f(denom)) * LN2;
    bf16* op = static_cast<bf16*>(p.o) + b * st.ob + row * st.ot + h * st.oh;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int c = n * 8 + 2 * tq;
      if (c < p.dv) store(op + c * st.od, acc[n][2 * r] / denom);
      if (c + 1 < p.dv) store(op + (c + 1) * st.od, acc[n][2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------- fp32 --

constexpr int F_WARPS = 8;        // 8 query rows each
constexpr int F_THREADS = 32 * F_WARPS;
constexpr int F_ROWS = BQ / F_WARPS;

// Row pitch of Q and K: DQ plus 4, so that the pitch is 4 times an odd
// number of words and 8 lanes reading float4 at 8 rows hit distinct banks.
// V's rows hold DV (lanes read 4 columns every 64). Two stages where they
// fit, else one.
template <int DQ, int DV>
struct FShape {
  static constexpr int LDQ = DQ + 4, LDV = DV;
  static constexpr int STAGE = BKV * (LDQ + LDV);
  static constexpr size_t bytes(int stages) {
    return sizeof(float) *
           (BQ * LDQ + stages * STAGE + F_WARPS * BKV * F_ROWS);
  }
  static constexpr int STAGES = bytes(2) <= SMEM_MAX ? 2 : 1;
  static constexpr size_t SMEM = bytes(STAGES);
  static_assert(SMEM <= SMEM_MAX, "one stage fits");
};

template <int DQ, int DV>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32(Params p) {
  using Sh = FShape<DQ, DV>;
  constexpr int LDQ = Sh::LDQ, LDV = Sh::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);      // (BQ, LDQ)
  float* ring = qs + BQ * LDQ;  // STAGES stages of K (BKV, LDQ), V (BKV, LDV)
  const Strides& st = p.st;
  const int t_len = p.t_len, s_len = p.s_len;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ry = lane >> 4, cx = lane & 15;
  const int qtile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qtile * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.n_heads / p.n_kv);
  const int off = s_len - t_len;
  const float* qp = static_cast<const float*>(p.q) + b * st.qb + h * st.qh;
  const float* kp = static_cast<const float*>(p.k) + b * st.kb + hk * st.kh;
  const float* vp = static_cast<const float*>(p.v) + b * st.vb + hk * st.vh;
  float* pw = ring + Sh::STAGES * Sh::STAGE + warp * BKV * F_ROWS;  // (BKV, 8)

  const KvRange blk = kv_range(q0 + off, min(q0 + BQ, t_len) - 1 + off,
                               s_len, p.causal, p.use_window, p.window);
  const int w0 = q0 + F_ROWS * warp;          // this warp's first row
  const bool active = w0 < t_len;
  const int wpos_lo = w0 + off, wpos_hi = min(w0 + F_ROWS, t_len) - 1 + off;
  const KvRange wr = wpos_lo >= 0 ? kv_range(wpos_lo, wpos_hi, s_len,
                                             p.causal, p.use_window, p.window)
                                  : blk;

  auto issue = [&](int j, float* dst) {
    const int k0 = j * BKV;
    load_tile<float, BKV, F_THREADS, DQ>(dst, LDQ, kp, st.kt, st.kd, k0,
                                         s_len, p.dq, p.vec & 2, tid);
    load_tile<float, BKV, F_THREADS, DV>(dst + BKV * LDQ, LDV, vp, st.vt,
                                         st.vd, k0, s_len, p.dv, p.vec & 4,
                                         tid);
  };
  load_tile<float, BQ, F_THREADS, DQ>(qs, LDQ, qp, st.qt, st.qd, q0, t_len,
                                      p.dq, p.vec & 1, tid);
  if (blk.begin < blk.end) issue(blk.begin, ring);
  cp_async_commit();

  // lane (ry, cx): rows 4 ry + i of the warp's 8; logits of keys cx + 16 j;
  // O columns 64 c + 4 cx + e
  float acc[4][DV / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DV / 16; ++c) acc[i][c] = 0.f;
  float m_r[4], l_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
  }
  const float* qrow = qs + (F_ROWS * warp + 4 * ry) * LDQ;

  for (int j = blk.begin; j < blk.end; ++j) {
    const int it = j - blk.begin;
    if (Sh::STAGES == 1 && it > 0) {
      __syncthreads();   // every warp is done with tile j - 1: load tile j
      issue(j, ring);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();   // tile j is in; every warp is done with tile j - 1
    if (Sh::STAGES == 2) {
      if (j + 1 < blk.end) issue(j + 1, ring + ((it + 1) & 1) * Sh::STAGE);
      cp_async_commit();
    }
    if (!active || j < wr.begin || j >= wr.end) continue;

    const float* ks = ring + (Sh::STAGES == 2 ? (it & 1) : 0) * Sh::STAGE;
    const float* vs = ks + BKV * LDQ;
    const int k0 = j * BKV;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    const float* krow = ks + cx * LDQ;
#pragma unroll 4
    for (int d = 0; d < DQ; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qrow + i * LDQ + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        c[jj] = *reinterpret_cast<const float4*>(krow + 16 * jj * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float t = s[i][jj];
          t = fmaf(a[i].x, c[jj].x, t);
          t = fmaf(a[i].y, c[jj].y, t);
          t = fmaf(a[i].z, c[jj].z, t);
          s[i][jj] = fmaf(a[i].w, c[jj].w, t);
        }
    }

    const bool need_mask = k0 + BKV > s_len ||
                           (p.causal && k0 + BKV - 1 > wpos_lo) ||
                           (p.use_window && k0 <= wpos_hi - p.window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m_r[i];
      const int pos = w0 + 4 * ry + i + off;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[i][jj] * p.scale_log2;
        if (need_mask) {
          const int key = k0 + cx + 16 * jj;
          if (key >= s_len)
            x = -INFINITY;
          else if ((p.causal && key > pos) ||
                   (p.use_window && key <= pos - p.window))
            x = NEG_INF;
        }
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int sh = 1; sh < 16; sh <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float corr = exp2f(m_r[i] - mx);
      m_r[i] = mx;
      l_r[i] *= corr;
#pragma unroll
      for (int c = 0; c < DV / 16; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float pe = exp2f(s[i][jj] - mx);
        s[i][jj] = pe;
        l_r[i] += pe;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(pw + (cx + 16 * jj) * F_ROWS + 4 * ry) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    __syncwarp();

    const int kv_n = min(BKV, s_len - k0);     // rows past S weigh 0
#pragma unroll 4
    for (int kk = 0; kk < kv_n; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(pw + kk * F_ROWS +
                                                         4 * ry);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < DV / 64; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + kk * LDV + 64 * c + 4 * cx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c] = fmaf(pr[i], vv.x, acc[i][4 * c]);
          acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);
        }
      }
    }
    __syncwarp();      // pw is read before the next tile writes it
  }

  cp_async_wait_all();   // nothing left in flight when no tile ran
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_r[i];
#pragma unroll
    for (int sh = 1; sh < 16; sh <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, sh);
    const int row = w0 + 4 * ry + i;
    if (row >= t_len) continue;
    const float denom = fmaxf(l, 1e-30f);
    if (p.lse != nullptr && cx == 0)
      p.lse[(static_cast<int64_t>(b) * p.n_heads + h) * t_len + row] =
          (m_r[i] + log2f(denom)) * LN2;
    float* op = static_cast<float*>(p.o) + b * st.ob + row * st.ot +
                h * st.oh;
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * cx + e;
        if (col < p.dv) op[col * st.od] = acc[i][4 * c + e] / denom;
      }
  }
}

template <typename K>
int launch(K kernel, size_t smem, int threads, int b, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.t_len + BQ - 1) / BQ, p.n_heads, b);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 (dtype 1) takes the tensor-core kernel, fp32 the CUDA-core one
template <int DQ, int DV>
int launch_t(int dtype, int b, const Params& p, cudaStream_t s) {
  if (dtype == 1)
    return launch(flash_fwd_bf16<DQ, DV>, TcShape<DQ, DV>::SMEM, TC_THREADS, b,
                  p, s);
  return launch(flash_fwd_f32<DQ, DV>, FShape<DQ, DV>::SMEM, F_THREADS, b, p,
                s);
}

// dv rounded up to 64 or 128
template <int DQ>
int launch_dq(int dtype, int b, const Params& p, cudaStream_t s) {
  return p.dv <= 64 ? launch_t<DQ, 64>(dtype, b, p, s)
                    : launch_t<DQ, 128>(dtype, b, p, s);
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel);
// q, k, v and o alike. lse: null, or (B, H, T) fp32 that receives each
// query row's natural-log logsumexp of its scaled, masked logits (the
// backward kernel's input; a row with no key gets a finite value below
// -1e29). strides: 16 int64 element strides, (b, t, h, d) of q,
// k, v, o in that order. vec: bit 0, 1, 2 set when q, k, v may be copied 16
// bytes at a time (last stride 1, other strides and the base 16-byte
// aligned); others are loaded element by element. Requires 1 <= dq, dv <=
// 256 and n_heads % n_kv == 0 (the wrapper checks). A head dim above 128
// pads both to 128 or 256 (three more instances a dtype, not six). Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_fwd(int dtype, const void* q,
                                         const void* k, const void* v,
                                         void* o, float* lse, int b,
                                         int t_len, int s_len,
                                         int n_heads, int n_kv, int dq, int dv,
                                         float scale, int causal,
                                         int use_window, int window, int vec,
                                         const void* strides, void* stream) {
  if (dq > DMAX || dv > DMAX || dq < 1 || dv < 1 || n_kv < 1 ||
      n_heads % n_kv != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = static_cast<const int64_t*>(strides);
  const Params p{q, k, v, o, lse, t_len, s_len, n_heads, n_kv, dq, dv,
                 scale * LOG2E, causal, use_window, window, vec,
                 Strides{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6],  s[7],
                         s[8], s[9], s[10], s[11], s[12], s[13], s[14],
                         s[15]}};
  auto str = static_cast<cudaStream_t>(stream);
  if (dq > 128 || dv > 128) {
    if (dq <= 128) return launch_t<128, 256>(dtype, b, p, str);
    return dv <= 128 ? launch_t<256, 128>(dtype, b, p, str)
                     : launch_t<256, 256>(dtype, b, p, str);
  }
  if (dq <= 32) return launch_dq<32>(dtype, b, p, str);
  if (dq <= 64) return launch_dq<64>(dtype, b, p, str);
  return launch_dq<128>(dtype, b, p, str);
}
