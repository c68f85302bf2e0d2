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
//   bwd_delta: D = rowsum(dO * O) for each (b, h, t), fp32, one warp a row
//     (16-byte loads where the rows allow);
//   dK/dV:     one block a (64-key tile, kv head, batch row). K and V of
//     the tile stay in shared memory; the block walks the group's query
//     heads and, for each, the query tiles that can see the tile (the
//     causal and window masks bound them), recomputes S = scale Q K^T and
//     P = exp(S - lse), and accumulates dV += P^T dO and dK += scale dS^T Q
//     with dP = dO V^T, dS = P (dP - D). The sum over the group is inside
//     the block, or in bf16 inside a cluster of two blocks that deal the
//     group's heads between them and add their accumulators through
//     distributed shared memory: no atomics, deterministic;
//   dQ:        one block a (64-row query tile, head, batch row), walking
//     the key tiles that the masks leave it: dQ += scale dS K.
// The launch plan (instance, tiles, grids, shared memory, the tiles each
// block walks) is mirrored by backward.Plan, which the wrapper passes in:
// the entry point refuses an instance or a shared-memory size it does not
// compute itself. Masked entries (and keys past S, rows past T) take P = 0,
// so a row with no valid key gets zero gradients and no NaN (the plain
// version, ref.attention_bwd, does the same).
//
// What bounds it on an H100 at 700 W: the gradient needs 5 products of
// T S d (2.5 times the forward's 2; about half under the causal mask)
// against the bytes of q, k, v, o, dO, dq, dk, dv once. That is bound by
// operations at DeiT-Base in fp32 (67 TFLOP/s on the CUDA cores) and by
// bytes or by the longest causal block at the LM shapes in bf16 (989
// TFLOP/s on the tensor cores). Without atomics the two passes each
// recompute S and dP: 7 products where 5 would do. The design keeps the
// products on the fastest unit the dtype allows and their operands out of
// device memory:
//
// bf16 (FlashAttention-2's backward on the tensor cores): every product is
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with operands from
// ldmatrix (ldmatrix.trans where the streamed tile is the B operand of a
// product over its rows). dK/dV: 8 warps, a pair for each 16 keys of the
// tile. Both warps of a pair take S^T = K Q^T and dP^T = V dO^T over the
// same 64 query rows at once, one each; the first forms P^T in registers,
// hands it to its partner through a 4 KB tile of shared memory in fragment
// order (bar.arrive / bar.sync on a named barrier a pair) and accumulates
// dV += P^T dO, the second forms dS^T = P^T (dP^T - D) and accumulates
// dK += dS^T Q: P^T and dS^T are repacked from accumulator fragments into
// bf16 A fragments and never round-trip as tiles. Splitting dK from dV
// over the pair keeps a thread's accumulator at max(dq, dv) / 2 registers
// (128 at d 256). dQ: 4 warps, 16 query rows each, S, dP and dS in
// registers, dQ += dS K; above head dim 128 a key tile is taken in two
// parts of 32 keys, which halves S and dP beside the 128-register dQ
// accumulator. So no instance spills. Where both head dims are at most
// 128 the warp's resident fragments (K or V, and Q) stay in registers.
//
// fp32 (register-tiled on the CUDA cores; TF32 would break the 1e-4 gate
// as it would the forward's): 256 threads, thread (ty, tx) = (tid / 16,
// tid % 16). Each takes a 4 x 4 micro-tile of S and dP (rows grouped by
// ty, keys tx + 16 j), reading both operands as float4 along d, writes P
// and dS to shared memory once a tile, then accumulates dV, dK (keys
// 4 ty .. + 4) or dQ (rows 4 ty .. + 4) as outer products over the tile's
// rows into a 4 x (d / 16) micro-tile of registers, SGEMM-fashion (4
// columns every 64). A warp skips the rows past T and the keys past S of a
// ragged tile (DeiT's 197 leaves a 5-row tile). Head dims above 128 stream
// 32-row tiles, so the resident tile and one stage fit a block.
//
// Occupancy: GQA at LM shapes leaves few dK/dV blocks (Qwen2-1.5B: 8 key
// tiles x 2 kv heads x 4 rows = 64 on 132 SMs, the first walking 6 heads
// x 8 query tiles), so bf16 splits an even group over a pair of blocks
// where there are fewer dK/dV blocks than SMs (backward.Plan.split; pairs
// measured faster than clusters of 3, 4 or 6); blocks that fit two an SM
// with one stage (bf16 dQ up to 192 / 128, fp32 at head dim 64) take one
// stage.
//
// Both: the streamed tiles (Q, dO, lse and D in dK/dV; K, V in dQ) move
// through a ring of two stages where they fit, else one, of 16-byte
// cp.async copies; a tensor whose rows cannot be copied 16 bytes at a
// time (vec bit clear) is loaded element by element by the same kernel.
// Head dims are compile-time: 64, 128, 192 / 128 (MLA) or 256, zeros in
// shared memory past the real dims (four instances a kernel).
//
// Measured at the train shapes (PERF.md §6): the bf16 passes run
// at 70-160 TFLOP/s of the 989, the dK/dV pass the slower; mma.sync on
// 16-row warp tiles at 4-8 warps an SM leaves the tensor cores waiting
// on ldmatrix and on each step's barrier. The next step is wgmma on
// TMA-loaded tiles. fp32 runs at about a third of the CUDA cores' peak,
// and the recomputed S and dP are 2 of its 7 products.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;            // keys of a dK/dV block
constexpr int BQ = 64;            // query rows of a dQ block
constexpr int LP = 68;            // fp32 pitch of P, dS: float4 rows
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have
constexpr int SMEM_HALF = 115712; // a block's share where two share an SM
constexpr int MAX_SPLIT = 2;      // blocks of a cluster that share a group
constexpr float LOG2E = 1.4426950408889634f;

// Stages of a block's ring: two where they fit `limit` (the block's share
// of an SM), else one
constexpr int stages(int resident, int stage, int extra, int limit) {
  return resident + 2 * stage + extra <= limit ? 2 : 1;
}

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
  int vec;            // bits 0-3: q, k, v, dO rows copy 16 bytes at a time;
                      // bit 4: o and dO rows read 16 bytes at a time
  int split;          // bf16 dK/dV: 2 when a pair of blocks shares a group
  Strides4 sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

__device__ __forceinline__ float ld(const void* p, int64_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int key, int pos, const BwdParams& p) {
  return key < p.s_len && (!p.causal || key <= pos) &&
         (!p.use_window || key > pos - p.window);
}

// Whether some entry of the (rows [t0, t0 + nt), keys [k0, k0 + nk)) block
// is masked: past T or S, above the causal diagonal or outside the window
__device__ __forceinline__ bool needs_mask(const BwdParams& p, int t0, int nt,
                                           int k0, int nk) {
  const int off = p.s_len - p.t_len;
  return t0 + nt > p.t_len || k0 + nk > p.s_len ||
         (p.causal && k0 + nk - 1 > t0 + off) ||
         (p.use_window && k0 <= t0 + nt - 1 + off - p.window);
}

struct Span {
  int lo, hi;
};
// Query rows [lo, hi) that see some key of [k0, k1): causal position >=
// k0, window position < k1 - 1 + window (backward.Plan.query_tiles)
__device__ __forceinline__ Span query_rows(const BwdParams& p, int k0,
                                           int k1) {
  const int off = p.s_len - p.t_len;
  Span r{0, p.t_len};
  if (p.causal) r.lo = max(0, k0 - off);
  if (p.use_window) r.hi = min(p.t_len, k1 - 1 + p.window - off);
  return r;
}
// Key tiles [lo, hi) of `tile` keys that some row of [q0, q0 + BQ) may see
// (backward.Plan.key_tiles)
__device__ __forceinline__ Span key_tiles(const BwdParams& p, int q0,
                                          int tile) {
  const int off = p.s_len - p.t_len;
  const int nk = (p.s_len + tile - 1) / tile;
  const int pos_lo = q0 + off, pos_hi = min(q0 + BQ, p.t_len) - 1 + off;
  Span r{0, nk};
  if (p.causal) r.hi = pos_hi < 0 ? 0 : min(nk, pos_hi / tile + 1);
  if (p.use_window) {                  // first tile holding a key > e
    const int e = pos_lo - p.window;
    r.lo = e < 0 ? 0 : (e + 1 >= p.s_len ? nk : (e + 1) / tile);
  }
  if (r.hi < r.lo) r.hi = r.lo;
  return r;
}

// lse and D of query rows [q0, q0 + n) of head h into dst[0, n) and
// dst[n, 2 n) by 4-byte cp.async copies; zeros past T. Threads [0, 2 n)
// copy.
__device__ __forceinline__ void load_stats(float* dst, const BwdParams& p,
                                           int b, int h, int q0, int n,
                                           int tid) {
  if (tid >= 2 * n) return;
  const int t = q0 + (tid < n ? tid : tid - n);
  const int64_t r = (static_cast<int64_t>(b) * p.n_heads + h) * p.t_len + t;
  const float* src = tid < n ? p.lse : p.delta;
  cp_async4(dst + tid, t < p.t_len ? src + r : src, t < p.t_len ? 4 : 0);
}

// A launch on the stream, as clusters of `cluster` blocks along x when
// cluster > 1
template <typename K>
int launch(K kernel, int smem, dim3 grid, int threads, const BwdParams& p,
           cudaStream_t s, int cluster = 1) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster == 1) {
    kernel<<<grid, threads, smem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = cluster;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- delta --

constexpr int DELTA_THREADS = 256;

// the dot of two 16-byte chunks of bf16 or fp32 values
__device__ __forceinline__ float dot16(uint4 a, uint4 b, int is_bf16) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (is_bf16) {
      const float2 u = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x[i]));
      const float2 w = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&y[i]));
      s = fmaf(u.x, w.x, fmaf(u.y, w.y, s));
    } else {
      s = fmaf(__uint_as_float(x[i]), __uint_as_float(y[i]), s);
    }
  }
  return s;
}

// vec bit 4: o and dO rows are read 16 bytes at a time (whole chunks)
__global__ void __launch_bounds__(DELTA_THREADS) bwd_delta(BwdParams p,
                                                           int b_n) {
  const int row = blockIdx.x * (DELTA_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int rows = b_n * p.n_heads * p.t_len;
  if (row >= rows) return;
  const int t = row % p.t_len;
  const int h = (row / p.t_len) % p.n_heads;
  const int b = row / (p.t_len * p.n_heads);
  const int64_t oo = b * p.so.b + t * p.so.t + h * p.so.h;
  const int64_t od = b * p.sdo.b + t * p.sdo.t + h * p.sdo.h;
  float s = 0.f;
  if (p.vec & 16) {
    const int es = p.bf16_in ? 2 : 4;
    const uint4* o4 = reinterpret_cast<const uint4*>(
        static_cast<const char*>(p.o) + oo * es);
    const uint4* d4 = reinterpret_cast<const uint4*>(
        static_cast<const char*>(p.dout) + od * es);
    for (int c = lane; c < p.dv_dim * es / 16; c += 32)
      s += dot16(o4[c], d4[c], p.bf16_in);
  } else {
    for (int c = lane; c < p.dv_dim; c += 32)
      s = fmaf(ld(p.o, oo + c * p.so.d, p.bf16_in),
               ld(p.dout, od + c * p.sdo.d, p.bf16_in), s);
  }
#pragma unroll
  for (int sh = 16; sh; sh >>= 1) s += __shfl_xor_sync(0xffffffffu, s, sh);
  if (lane == 0) p.delta[row] = s;
}

// ---------------------------------------------------------------- bf16 --

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The A fragments of a warp's 16 rows at `as` (pitch la), d in [0, D)
template <int D, int NA>
__device__ __forceinline__ void load_a(uint32_t (&af)[NA][4], const bf16* as,
                                       int la, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(af[kk], as + (lane & 15) * la + kk * 16 + ((lane >> 4) << 3));
}

// x (16 rows of A by 8 NX rows of B) = A B^T over d in [0, D): A's
// fragments held in `af` (HELD) or read from its 16 rows at `as` (pitch
// la); B's rows at `bs` (pitch lb), read by ldmatrix
template <int D, bool HELD, int NX, int NA>
__device__ __forceinline__ void prod(float (&x)[NX][4],
                                     const uint32_t (&af)[NA][4],
                                     const bf16* as, int la, const bf16* bs,
                                     int lb, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int n = 0; n < NX; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (HELD) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = af[kk][e];
    } else {
      ldmatrix_x4(a, as + (lane & 15) * la + kk * 16 + ((lane >> 4) << 3));
    }
#pragma unroll
    for (int n2 = 0; n2 < NX / 2; ++n2) {
      uint32_t bk[4];
      ldmatrix_x4(bk, bs + (n2 * 16 + ((mi >> 1) << 3) + (lane & 7)) * lb +
                          kk * 16 + ((mi & 1) << 3));
      mma_bf16(x[2 * n2], a, bk[0], bk[1]);
      mma_bf16(x[2 * n2 + 1], a, bk[2], bk[3]);
    }
  }
}

// acc[0, W / 8) += X B: X the 16 x 8 NX accumulator x rounded to bf16 (A
// fragments), B's 8 NX rows at `bs` (pitch lb, W columns), read by
// ldmatrix.trans
template <int W, int NX, int NA>
__device__ __forceinline__ void accum(float (&acc)[NA][4],
                                      const float (&x)[NX][4], const bf16* bs,
                                      int lb, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < NX / 2; ++kk) {
    uint32_t pa[4];
    acc_to_a(pa, x, kk);
#pragma unroll
    for (int n2 = 0; n2 < W / 16; ++n2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, bs + (kk * 16 + ((mi & 1) << 3) + (lane & 7)) *
                                     lb + n2 * 16 + ((mi >> 1) << 3));
      mma_bf16(acc[2 * n2], pa, bv[0], bv[1]);
      mma_bf16(acc[2 * n2 + 1], pa, bv[2], bv[3]);
    }
  }
}

// Rows r0 + g, r0 + g + 8 and columns [0, dim) of a 16-row accumulator
// (W columns, the m16n8 C layout) times mul into out (row stride sr,
// element stride sd); rows past len are not written, nor the values
// acc[n][e] with 4 n + e outside [lo, hi) (another block of the cluster
// stores them)
template <int W, int NA>
__device__ __forceinline__ void store_acc(bf16* out, int64_t sr, int64_t sd,
                                          int r0, int len, int dim,
                                          const float (&acc)[NA][4],
                                          float mul, int lane, int lo = 0,
                                          int hi = 4 * NA) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), col = n * 8 + 2 * tq + (e & 1);
      if (row < len && col < dim && 4 * n + e >= lo && 4 * n + e < hi)
        st(out + row * sr + col * sd, acc[n][e] * mul);
    }
}

// Each thread's accumulator summed over the pair of blocks of its cluster
// (no atomics): the block's values go to shared memory at `red` (every
// warp must be done with what lay there), and the thread's values
// [lo, hi), the block's half of the 4 NA, become the pair's sums (only
// those are stored). A sum of two is the same whichever block adds it, so
// the result is deterministic.
template <int NA>
__device__ __forceinline__ void pair_sum(float (&acc)[NA][4], float* red,
                                         int lo, int hi, int tid,
                                         int threads) {
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int i = 0; i < 4 * NA; ++i) red[i * threads + tid] = acc[i / 4][i % 4];
  cluster.sync();
  const float* other =
      cluster.map_shared_rank(red, 1 - static_cast<int>(cluster.block_rank()));
#pragma unroll
  for (int i = 0; i < 4 * NA; ++i)
    if (i >= lo && i < hi) acc[i / 4][i % 4] += other[i * threads + tid];
  cluster.sync();        // no block leaves while the other reads it
}

// dK/dV: rows padded 16 bytes (ldmatrix's 8 rows on distinct banks)
template <int DQ, int DV>
struct TcKv {
  static constexpr int LDQ = DQ + 8, LDV = DV + 8;
  static constexpr int TQ = 64;                          // streamed rows
  static constexpr int RES = 2 * BK * (LDQ + LDV);       // K, V
  static constexpr int STAGE = 2 * TQ * (LDQ + LDV) + 8 * TQ;  // Q, dO, stats
  static constexpr int PEX = 4 * 8 * 32 * 16;            // P^T, 4 pairs
  static constexpr int STAGES = RES + 2 * STAGE + PEX <= SMEM_MAX ? 2 : 1;
  static constexpr int SMEM = RES + STAGES * STAGE + PEX;
  static constexpr bool HELD = DQ <= 128 && DV <= 128;   // K, V fragments
  static constexpr int DM = DQ > DV ? DQ : DV;
  static_assert(SMEM <= SMEM_MAX, "one stage fits");
  static_assert(DM / 2 * 256 * 4 <= SMEM, "pair_sum fits");
};

template <int DQ, int DV>
__global__ void __launch_bounds__(256) bwd_dkdv_bf16(BwdParams p) {
  using L = TcKv<DQ, DV>;
  constexpr int LDQ = L::LDQ, LDV = L::LDV, TQ = L::TQ;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);              // (BK, LDQ)
  bf16* vs = ks + BK * LDQ;                              // (BK, LDV)
  unsigned char* ring = smem + L::RES;
  float4* pex = reinterpret_cast<float4*>(ring + L::STAGES * L::STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // key group kg: keys 16 kg .. + 16; role 0: P^T and dV, 1: dP^T and dK
  const int kg = warp & 3, role = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;
  // `split` blocks (a cluster, 1 or 2) share a key tile: block `rank`
  // takes the group's heads rank, rank + split, ...
  const int split = p.split, rank = blockIdx.x % split;
  const int k0 = blockIdx.x / split * BK, hk = blockIdx.y, b = blockIdx.z;
  const int grp = p.n_heads / p.n_kv;
  const int t_len = p.t_len, s_len = p.s_len, off = s_len - t_len;
  const Span rows = query_rows(p, k0, min(k0 + BK, s_len));
  const int qt0 = rows.lo / TQ;
  const int nqt = rows.hi > rows.lo ? (rows.hi + TQ - 1) / TQ - qt0 : 0;
  const int n = grp / split * nqt;     // (head, query tile) steps

  auto stage = [&](int it) {
    return ring + (L::STAGES == 2 ? (it & 1) * L::STAGE : 0);
  };
  auto issue = [&](int it) {
    const int h = hk * grp + rank + split * (it / nqt);
    const int q0 = (qt0 + it % nqt) * TQ;
    bf16* qs = reinterpret_cast<bf16*>(stage(it));
    bf16* dos = qs + TQ * LDQ;
    load_tile<bf16, TQ, 256, DQ>(
        qs, LDQ, static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h,
        p.sq.t, p.sq.d, q0, t_len, p.dq_dim, p.vec & 1, tid);
    load_tile<bf16, TQ, 256, DV>(
        dos, LDV,
        static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h,
        p.sdo.t, p.sdo.d, q0, t_len, p.dv_dim, p.vec & 8, tid);
    load_stats(reinterpret_cast<float*>(dos + TQ * LDV), p, b, h, q0, TQ,
               tid);
  };

  float acc[L::DM / 8][4];
#pragma unroll
  for (int j = 0; j < L::DM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t af[L::HELD ? L::DM / 16 : 1][4];
  const float sl2 = p.scale * LOG2E;
  const bf16* as = role == 0 ? ks + 16 * kg * LDQ : vs + 16 * kg * LDV;

  if (n > 0) {
    load_tile<bf16, BK, 256, DQ>(
        ks, LDQ, static_cast<const bf16*>(p.k) + b * p.sk.b + hk * p.sk.h,
        p.sk.t, p.sk.d, k0, s_len, p.dq_dim, p.vec & 2, tid);
    load_tile<bf16, BK, 256, DV>(
        vs, LDV, static_cast<const bf16*>(p.v) + b * p.sv.b + hk * p.sv.h,
        p.sv.t, p.sv.d, k0, s_len, p.dv_dim, p.vec & 4, tid);
    issue(0);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    if (L::STAGES == 1 && it > 0) {
      __syncthreads();   // every warp is done with step it - 1: load step it
      issue(it);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();     // step it is in; every warp is done with it - 1
    if (L::STAGES == 2) {
      if (it + 1 < n) issue(it + 1);
      cp_async_commit();
    }
    if constexpr (L::HELD) {
      if (it == 0) {
        if (role == 0)
          load_a<DQ>(af, as, LDQ, lane);
        else
          load_a<DV>(af, as, LDV, lane);
      }
    }
    const bf16* qs = reinterpret_cast<const bf16*>(stage(it));
    const bf16* dos = qs + TQ * LDQ;
    const float* ls = reinterpret_cast<const float*>(dos + TQ * LDV);
    const int q0 = (qt0 + it % nqt) * TQ;

    float x[8][4];   // rows: this pair's 16 keys; columns: the 64 query rows
    if (role == 0) {
      prod<DQ, L::HELD>(x, af, as, LDQ, qs, LDQ, lane);          // S^T
      const bool mask = needs_mask(p, q0, TQ, k0 + 16 * kg, 16);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = c * 8 + 2 * tq + (e & 1);    // query row of the tile
          float pr = exp2f(fmaf(x[c][e], sl2, -ls[r] * LOG2E));
          if (mask && !(q0 + r < t_len &&
                        visible(k0 + 16 * kg + g + 8 * (e >> 1),
                                q0 + r + off, p)))
            pr = 0.f;
          x[c][e] = pr;
        }
#pragma unroll
      for (int c = 0; c < 8; ++c)
        pex[(kg * 8 + c) * 32 + lane] =
            make_float4(x[c][0], x[c][1], x[c][2], x[c][3]);
      bar_arrive(1 + kg, 64);
      accum<DV>(acc, x, dos, LDV, lane);                          // dV
    } else {
      prod<DV, L::HELD>(x, af, as, LDV, dos, LDV, lane);         // dP^T
      bar_sync(1 + kg, 64);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 pr = pex[(kg * 8 + c) * 32 + lane];
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[c][e] = pv[e] * (x[c][e] - ls[TQ + c * 8 + 2 * tq + (e & 1)]);
      }
      accum<DQ>(acc, x, qs, LDQ, lane);                           // dK
    }
  }
  // this block's share of a thread's values: [lo, hi) of its 4 NA
  constexpr int NV = L::DM / 2;
  const int lo = rank * NV / split, hi = (rank + 1) * NV / split;
  if (split > 1) {
    __syncthreads();     // every warp is done with the ring, K and V
    pair_sum(acc, reinterpret_cast<float*>(smem), lo, hi, tid, 256);
  }
  if (role == 0)
    store_acc<DV>(static_cast<bf16*>(p.dv) + b * p.sdv.b + hk * p.sdv.h,
                  p.sdv.t, p.sdv.d, k0 + 16 * kg, s_len, p.dv_dim, acc, 1.f,
                  lane, lo, hi);
  else
    store_acc<DQ>(static_cast<bf16*>(p.dk) + b * p.sdk.b + hk * p.sdk.h,
                  p.sdk.t, p.sdk.d, k0 + 16 * kg, s_len, p.dq_dim, acc,
                  p.scale, lane, lo, hi);
}

template <int DQ, int DV>
struct TcQ {
  static constexpr int LDQ = DQ + 8, LDV = DV + 8;
  static constexpr int TK = 64;                          // streamed keys
  static constexpr int RES = 2 * BQ * (LDQ + LDV);       // Q, dO
  static constexpr int STAGE = 2 * TK * (LDQ + LDV);     // K, V
  // two blocks of 4 warps an SM where one stage lets them
  static constexpr int BLOCKS = RES + STAGE <= SMEM_HALF ? 2 : 1;
  static constexpr int STAGES =
      stages(RES, STAGE, 0, BLOCKS == 2 ? SMEM_HALF : SMEM_MAX);
  static constexpr int SMEM = RES + STAGES * STAGE;
  static constexpr bool HELD = DQ <= 128 && DV <= 128;   // Q fragments
  // above 128 a key tile is taken in two parts of 32 keys, so that S and
  // dP of a part (16 registers each) fit beside the dQ accumulator
  static constexpr int PARTS = DQ > 128 ? 2 : 1;
  static_assert(SMEM <= SMEM_MAX, "one stage fits");
};

template <int DQ, int DV>
__global__ void __launch_bounds__(128) bwd_dq_bf16(BwdParams p) {
  using L = TcQ<DQ, DV>;
  constexpr int LDQ = L::LDQ, LDV = L::LDV, TK = L::TK;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);              // (BQ, LDQ)
  bf16* dos = qs + BQ * LDQ;                             // (BQ, LDV)
  bf16* ring = dos + BQ * LDV;       // STAGES of K (TK, LDQ), V (TK, LDV)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // heaviest causal tiles first
  const int qtile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qtile * BQ, w0 = q0 + 16 * warp;   // this warp's rows
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.n_heads / p.n_kv);
  const int t_len = p.t_len, s_len = p.s_len, off = s_len - t_len;
  const Span kt = key_tiles(p, q0, TK);
  const int n = kt.hi - kt.lo;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.sv.b + hk * p.sv.h;

  auto stage = [&](int it) {
    return ring + (L::STAGES == 2 ? (it & 1) : 0) * TK * (LDQ + LDV);
  };
  auto issue = [&](int it) {
    bf16* dst = stage(it);
    const int k0 = (kt.lo + it) * TK;
    load_tile<bf16, TK, 128, DQ>(dst, LDQ, kp, p.sk.t, p.sk.d, k0, s_len,
                                 p.dq_dim, p.vec & 2, tid);
    load_tile<bf16, TK, 128, DV>(dst + TK * LDQ, LDV, vp, p.sv.t, p.sv.d, k0,
                                 s_len, p.dv_dim, p.vec & 4, tid);
  };

  float acc[DQ / 8][4];
#pragma unroll
  for (int j = 0; j < DQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[L::HELD ? DQ / 16 : 1][4];
  float lse2[2], del[2];               // rows w0 + g and w0 + g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = w0 + g + 8 * r;
    const int64_t i = (static_cast<int64_t>(b) * p.n_heads + h) * t_len + t;
    lse2[r] = t < t_len ? p.lse[i] * LOG2E : 0.f;
    del[r] = t < t_len ? p.delta[i] : 0.f;
  }
  const float sl2 = p.scale * LOG2E;
  const bf16* qw = qs + 16 * warp * LDQ;
  const bf16* dow = dos + 16 * warp * LDV;

  if (n > 0) {
    load_tile<bf16, BQ, 128, DQ>(
        qs, LDQ, static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h,
        p.sq.t, p.sq.d, q0, t_len, p.dq_dim, p.vec & 1, tid);
    load_tile<bf16, BQ, 128, DV>(
        dos, LDV,
        static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h,
        p.sdo.t, p.sdo.d, q0, t_len, p.dv_dim, p.vec & 8, tid);
    issue(0);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    if (L::STAGES == 1 && it > 0) {
      __syncthreads();   // every warp is done with tile it - 1: load tile it
      issue(it);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();     // tile it is in; every warp is done with it - 1
    if (L::STAGES == 2) {
      if (it + 1 < n) issue(it + 1);
      cp_async_commit();
    }
    if constexpr (L::HELD) {
      if (it == 0) load_a<DQ>(qf, qw, LDQ, lane);
    }
    if (w0 >= t_len) continue;       // no row of this warp: nothing to add
#pragma unroll 1
    for (int part = 0; part < L::PARTS; ++part) {
      const int kp = part * (TK / L::PARTS);   // the part's first key
      const bf16* ks = stage(it) + kp * LDQ;
      const bf16* vs = stage(it) + TK * LDQ + kp * LDV;
      const int k0 = (kt.lo + it) * TK + kp;

      float x[8 / L::PARTS][4], y[8 / L::PARTS][4];
      prod<DQ, L::HELD>(x, qf, qw, LDQ, ks, LDQ, lane);          // S
      const bool mask = needs_mask(p, w0, 16, k0, TK / L::PARTS);
#pragma unroll
      for (int c = 0; c < 8 / L::PARTS; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(x[c][e] * sl2 - lse2[e >> 1]);
          const int t = w0 + g + 8 * (e >> 1);
          if (mask && !(t < t_len &&
                        visible(k0 + c * 8 + 2 * tq + (e & 1), t + off, p)))
            pr = 0.f;
          x[c][e] = pr;
        }
      prod<DV, false>(y, qf, dow, LDV, vs, LDV, lane);           // dP
#pragma unroll
      for (int c = 0; c < 8 / L::PARTS; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[c][e] *= y[c][e] - del[e >> 1];  // dS
      accum<DQ>(acc, x, ks, LDQ, lane);                           // dQ
    }
  }
  store_acc<DQ>(static_cast<bf16*>(p.dq) + b * p.sdq.b + h * p.sdq.h,
                p.sdq.t, p.sdq.d, w0, t_len, p.dq_dim, acc, p.scale, lane);
}

// ---------------------------------------------------------------- fp32 --

constexpr int F_THREADS = 256;

// s[i][j] = sum over d in [0, D) of a_i . b_j: a_i row i of `a` (pitch la),
// b_j row 16 j of `bk` (pitch lb), both read as float4 along d; key groups
// j >= jn (past S) are skipped
template <int D, int NI, int NJ>
__device__ __forceinline__ void dots(float (&s)[NI][NJ], const float* a,
                                     int la, const float* bk, int lb,
                                     int jn) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[NI], y[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + i * la + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < jn) y[j] = *reinterpret_cast<const float4*>(bk + 16 * j * lb + d);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j < jn) {
          float t = s[i][j];
          t = fmaf(x[i].x, y[j].x, t);
          t = fmaf(x[i].y, y[j].y, t);
          t = fmaf(x[i].z, y[j].z, t);
          s[i][j] = fmaf(x[i].w, y[j].w, t);
        }
  }
}

// acc[r][4 m + e] += w[r] * row[64 m + e] for m < D / 64 (row: this
// thread's first column, 4 tx)
template <int D>
__device__ __forceinline__ void outer(float (&acc)[4][D / 16], float4 w,
                                      const float* row) {
  const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int m = 0; m < D / 64; ++m) {
    const float4 y = *reinterpret_cast<const float4*>(row + 64 * m);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r][4 * m] = fmaf(wr[r], y.x, acc[r][4 * m]);
      acc[r][4 * m + 1] = fmaf(wr[r], y.y, acc[r][4 * m + 1]);
      acc[r][4 * m + 2] = fmaf(wr[r], y.z, acc[r][4 * m + 2]);
      acc[r][4 * m + 3] = fmaf(wr[r], y.w, acc[r][4 * m + 3]);
    }
  }
}

// rows r0 + r (r < 4), columns 64 m + 4 tx + e of acc times mul into out
template <int D>
__device__ __forceinline__ void store_tile(float* out, int64_t sr, int64_t sd,
                                           int r0, int len, int dim,
                                           const float (&acc)[4][D / 16],
                                           float mul, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r0 + r >= len) break;
#pragma unroll
    for (int m = 0; m < D / 64; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * m + 4 * tx + e;
        if (col < dim) out[(r0 + r) * sr + col * sd] = acc[r][4 * m + e] * mul;
      }
  }
}

// dK/dV: K and V rows padded 4 words (16 rows of a warp on distinct banks)
template <int DQ, int DV>
struct FKv {
  static constexpr int TQ = DQ > 128 || DV > 128 ? 32 : 64;   // streamed
  static constexpr int LKQ = DQ + 4, LKV = DV + 4;
  static constexpr int RES = 4 * BK * (LKQ + LKV);       // K, V
  static constexpr int STAGE = 4 * TQ * (DQ + DV + 2);   // Q, dO, stats
  static constexpr int PDS = 8 * TQ * LP;                // P, dS
  // head dims of 64: two blocks an SM (128 registers, one stage each)
  static constexpr int BLOCKS = DQ <= 64 && DV <= 64 ? 2 : 1;
  static constexpr int LIMIT = BLOCKS == 2 ? SMEM_HALF : SMEM_MAX;
  static constexpr int STAGES = stages(RES, STAGE, PDS, LIMIT);
  static constexpr int SMEM = RES + STAGES * STAGE + PDS;
  static_assert(SMEM <= LIMIT, "one stage fits");
};

template <int DQ, int DV>
__global__ void __launch_bounds__(F_THREADS, FKv<DQ, DV>::BLOCKS)
    bwd_dkdv_f32(BwdParams p) {
  using L = FKv<DQ, DV>;
  constexpr int TQ = L::TQ, RI = TQ / 16, LKQ = L::LKQ, LKV = L::LKV;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);            // (BK, LKQ)
  float* vs = ks + BK * LKQ;                             // (BK, LKV)
  unsigned char* ring = smem + L::RES;
  float* ps = reinterpret_cast<float*>(ring + L::STAGES * L::STAGE);
  float* dss = ps + TQ * LP;                             // (TQ, LP) each

  const int tid = threadIdx.x, warp = tid >> 5, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int grp = p.n_heads / p.n_kv;
  const int t_len = p.t_len, s_len = p.s_len, off = s_len - t_len;
  const int kn = min(BK, s_len - k0), jn = (kn + 15) / 16;
  const Span rows = query_rows(p, k0, k0 + kn);
  const int qt0 = rows.lo / TQ;
  const int nqt = rows.hi > rows.lo ? (rows.hi + TQ - 1) / TQ - qt0 : 0;
  const int n = grp * nqt;

  auto stage = [&](int it) {
    return reinterpret_cast<float*>(
        ring + (L::STAGES == 2 ? (it & 1) * L::STAGE : 0));
  };
  auto issue = [&](int it) {
    const int h = hk * grp + it / nqt, q0 = (qt0 + it % nqt) * TQ;
    float* qs = stage(it);
    load_tile<float, TQ, F_THREADS, DQ>(
        qs, DQ, static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h,
        p.sq.t, p.sq.d, q0, t_len, p.dq_dim, p.vec & 1, tid);
    load_tile<float, TQ, F_THREADS, DV>(
        qs + TQ * DQ, DV,
        static_cast<const float*>(p.dout) + b * p.sdo.b + h * p.sdo.h,
        p.sdo.t, p.sdo.d, q0, t_len, p.dv_dim, p.vec & 8, tid);
    load_stats(qs + TQ * (DQ + DV), p, b, h, q0, TQ, tid);
  };

  // keys 4 ty + r; columns 64 m + 4 tx + e
  float dk[4][DQ / 16], dv[4][DV / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < DQ / 16; ++c) dk[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DV / 16; ++c) dv[r][c] = 0.f;
  }
  const float sl2 = p.scale * LOG2E;

  if (n > 0) {
    load_tile<float, BK, F_THREADS, DQ>(
        ks, LKQ, static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h,
        p.sk.t, p.sk.d, k0, s_len, p.dq_dim, p.vec & 2, tid);
    load_tile<float, BK, F_THREADS, DV>(
        vs, LKV, static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h,
        p.sv.t, p.sv.d, k0, s_len, p.dv_dim, p.vec & 4, tid);
    issue(0);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    if (L::STAGES == 1 && it > 0) {
      __syncthreads();   // every warp is done with step it - 1: load step it
      issue(it);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();     // step it is in; every warp is done with it - 1
    if (L::STAGES == 2) {
      if (it + 1 < n) issue(it + 1);
      cp_async_commit();
    }
    const float* qs = stage(it);
    const float* dos = qs + TQ * DQ;
    const float* ls = dos + TQ * DV;
    const int q0 = (qt0 + it % nqt) * TQ;
    const int qn = min(TQ, t_len - q0);

    // S and dP: query rows RI ty + i, keys tx + 16 j (the warp's rows
    // 2 RI warp .. + 2 RI)
    if (2 * RI * warp < qn) {
      float s[RI][4], dp[RI][4];
      dots<DQ>(s, qs + RI * ty * DQ, DQ, ks + tx * LKQ, LKQ, jn);
      dots<DV>(dp, dos + RI * ty * DV, DV, vs + tx * LKV, LKV, jn);
      const bool mask = needs_mask(p, q0, TQ, k0, BK);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = RI * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          float pr = exp2f(fmaf(s[i][j], sl2, -ls[r] * LOG2E));
          if (mask && !(q0 + r < t_len && visible(key, q0 + r + off, p)))
            pr = 0.f;
          ps[r * LP + tx + 16 * j] = pr;
          dss[r * LP + tx + 16 * j] = pr * (dp[i][j] - ls[TQ + r]);
        }
      }
    }
    __syncthreads();     // P and dS of the tile are in
    // dV += P^T dO, dK += dS^T Q over the tile's rows: keys 4 ty + r (the
    // warp's keys 8 warp .. + 8)
    if (8 * warp < kn) {
#pragma unroll 2
      for (int q = 0; q < qn; ++q) {
        outer<DV>(dv, *reinterpret_cast<const float4*>(ps + q * LP + 4 * ty),
                  dos + q * DV + 4 * tx);
        outer<DQ>(dk, *reinterpret_cast<const float4*>(dss + q * LP + 4 * ty),
                  qs + q * DQ + 4 * tx);
      }
    }
  }
  float* dkp = static_cast<float*>(p.dk) + b * p.sdk.b + hk * p.sdk.h;
  float* dvp = static_cast<float*>(p.dv) + b * p.sdv.b + hk * p.sdv.h;
  store_tile<DQ>(dkp, p.sdk.t, p.sdk.d, k0 + 4 * ty, s_len, p.dq_dim, dk,
                 p.scale, tx);
  store_tile<DV>(dvp, p.sdv.t, p.sdv.d, k0 + 4 * ty, s_len, p.dv_dim, dv,
                 1.f, tx);
}

// dQ: K and V rows padded 4 words
template <int DQ, int DV>
struct FQ {
  static constexpr int TK = DQ > 128 || DV > 128 ? 32 : 64;   // streamed
  static constexpr int LKQ = DQ + 4, LKV = DV + 4;
  static constexpr int RES = 4 * BQ * (DQ + DV);         // Q, dO
  static constexpr int STAGE = 4 * TK * (LKQ + LKV);     // K, V
  static constexpr int DST = 4 * TK * LP;                // dS^T
  static constexpr int BLOCKS = DQ <= 64 && DV <= 64 ? 2 : 1;
  static constexpr int LIMIT = BLOCKS == 2 ? SMEM_HALF : SMEM_MAX;
  static constexpr int STAGES = stages(RES, STAGE, DST, LIMIT);
  static constexpr int SMEM = RES + STAGES * STAGE + DST;
  static_assert(SMEM <= LIMIT, "one stage fits");
};

template <int DQ, int DV>
__global__ void __launch_bounds__(F_THREADS, FQ<DQ, DV>::BLOCKS)
    bwd_dq_f32(BwdParams p) {
  using L = FQ<DQ, DV>;
  constexpr int TK = L::TK, NJ = TK / 16, LKQ = L::LKQ, LKV = L::LKV;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);            // (BQ, DQ)
  float* dos = qs + BQ * DQ;                             // (BQ, DV)
  float* ring = dos + BQ * DV;       // STAGES of K (TK, LKQ), V (TK, LKV)
  float* dst = ring + L::STAGES * TK * (LKQ + LKV);      // (TK, LP)

  const int tid = threadIdx.x, warp = tid >> 5, tx = tid & 15, ty = tid >> 4;
  const int qtile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qtile * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.n_heads / p.n_kv);
  const int t_len = p.t_len, s_len = p.s_len, off = s_len - t_len;
  const int qn = min(BQ, t_len - q0);
  const Span kt = key_tiles(p, q0, TK);
  const int n = kt.hi - kt.lo;
  const float* kp = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const float* vp = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;

  auto stage = [&](int it) {
    return ring + (L::STAGES == 2 ? (it & 1) : 0) * TK * (LKQ + LKV);
  };
  auto issue = [&](int it) {
    float* d = stage(it);
    const int k0 = (kt.lo + it) * TK;
    load_tile<float, TK, F_THREADS, DQ>(d, LKQ, kp, p.sk.t, p.sk.d, k0, s_len,
                                        p.dq_dim, p.vec & 2, tid);
    load_tile<float, TK, F_THREADS, DV>(d + TK * LKQ, LKV, vp, p.sv.t,
                                        p.sv.d, k0, s_len, p.dv_dim,
                                        p.vec & 4, tid);
  };

  // rows 4 ty + i (the warp's rows 8 warp .. + 8), columns 64 m + 4 tx + e
  float acc[4][DQ / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DQ / 16; ++c) acc[i][c] = 0.f;
  float lse2[4], del[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    const int64_t r = (static_cast<int64_t>(b) * p.n_heads + h) * t_len + t;
    lse2[i] = t < t_len ? p.lse[r] * LOG2E : 0.f;
    del[i] = t < t_len ? p.delta[r] : 0.f;
  }
  const float sl2 = p.scale * LOG2E;
  const bool rows_in = 8 * warp < qn;

  if (n > 0) {
    load_tile<float, BQ, F_THREADS, DQ>(
        qs, DQ, static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h,
        p.sq.t, p.sq.d, q0, t_len, p.dq_dim, p.vec & 1, tid);
    load_tile<float, BQ, F_THREADS, DV>(
        dos, DV,
        static_cast<const float*>(p.dout) + b * p.sdo.b + h * p.sdo.h,
        p.sdo.t, p.sdo.d, q0, t_len, p.dv_dim, p.vec & 8, tid);
    issue(0);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    if (L::STAGES == 1 && it > 0) {
      __syncthreads();   // every warp is done with tile it - 1: load tile it
      issue(it);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();     // tile it is in; every warp is done with it - 1
    if (L::STAGES == 2) {
      if (it + 1 < n) issue(it + 1);
      cp_async_commit();
    }
    if (!rows_in) continue;
    const float* ks = stage(it);
    const float* vs = ks + TK * LKQ;
    const int k0 = (kt.lo + it) * TK;
    const int kn = min(TK, s_len - k0), jn = (kn + 15) / 16;

    // S, dP and dS: rows 4 ty + i, keys tx + 16 j; dS^T to shared memory
    float s[4][NJ], dp[4][NJ];
    dots<DQ>(s, qs + 4 * ty * DQ, DQ, ks + tx * LKQ, LKQ, jn);
    dots<DV>(dp, dos + 4 * ty * DV, DV, vs + tx * LKV, LKV, jn);
    const bool mask = needs_mask(p, q0, BQ, k0, TK);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int key = k0 + tx + 16 * j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q0 + 4 * ty + i;
        float pr = exp2f(s[i][j] * sl2 - lse2[i]);
        if (mask && !(t < t_len && visible(key, t + off, p))) pr = 0.f;
        ds[i] = pr * (dp[i][j] - del[i]);
      }
      *reinterpret_cast<float4*>(dst + (tx + 16 * j) * LP + 4 * ty) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();        // a warp reads back only its own rows' dS
    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int k = 0; k < kn; ++k)
      outer<DQ>(acc, *reinterpret_cast<const float4*>(dst + k * LP + 4 * ty),
                ks + k * LKQ + 4 * tx);
  }
  store_tile<DQ>(static_cast<float*>(p.dq) + b * p.sdq.b + h * p.sdq.h,
                 p.sdq.t, p.sdq.d, q0 + 4 * ty, t_len, p.dq_dim, acc,
                 p.scale, tx);
}

// ------------------------------------------------------------- dispatch --

// bf16 (dtype 1) takes the tensor-core kernels, fp32 the CUDA-core ones;
// smem_kv / smem_q are backward.Plan's, checked against this file's own
template <int DQ, int DV>
int launch_dims(int dtype, int b, const BwdParams& p, int smem_kv,
                int smem_q, cudaStream_t s) {
  const dim3 gkv((p.s_len + BK - 1) / BK * p.split, p.n_kv, b);
  const dim3 gq((p.t_len + BQ - 1) / BQ, p.n_heads, b);
  if (dtype == 1) {
    if (smem_kv != TcKv<DQ, DV>::SMEM || smem_q != TcQ<DQ, DV>::SMEM)
      return static_cast<int>(cudaErrorInvalidValue);
    const int err =
        launch(bwd_dkdv_bf16<DQ, DV>, smem_kv, gkv, 256, p, s, p.split);
    if (err) return err;
    return launch(bwd_dq_bf16<DQ, DV>, smem_q, gq, 128, p, s);
  }
  if (smem_kv != FKv<DQ, DV>::SMEM || smem_q != FQ<DQ, DV>::SMEM ||
      p.split != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch(bwd_dkdv_f32<DQ, DV>, smem_kv, gkv, F_THREADS, p, s);
  if (err) return err;
  return launch(bwd_dq_f32<DQ, DV>, smem_q, gq, F_THREADS, p, s);
}

Strides4 strides4(const int64_t* s) { return Strides4{s[0], s[1], s[2], s[3]}; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dO, dq, dk, dv alike.
// lse: (B, H, T) fp32 natural-log logsumexp of the scaled logits (the
// forward kernel's); delta: (B, H, T) fp32 scratch. vec: bits 0-3 set when
// q, k, v, dO may be copied 16 bytes at a time (ops.rows16), bit 4 when o
// and dO may be and a row is whole 16-byte chunks. dq_pad,
// dv_pad: the instance, one of 64/64, 128/128, 192/128, 256/256, covering
// dq_dim and dv_dim; split: the blocks of a cluster that share a bf16
// dK/dV tile, 1 or 2 dividing the group n_heads / n_kv (1 for fp32); smem_kv, smem_q: the two launches' dynamic shared memory
// (backward.Plan gives all five; anything else is refused with
// cudaErrorInvalidValue). strides: 32 int64 element strides, (b, t, h, d)
// of q, k, v, o, dO, dq, dk, dv in that order. Requires n_heads % n_kv ==
// 0 (the wrapper checks). Three launches (delta, dK/dV, dQ); returns
// cudaGetLastError() after the last, or the first launch's error.
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int t_len, int s_len, int n_heads, int n_kv, int dq_dim,
    int dv_dim, float scale, int causal, int use_window, int window, int vec,
    int dq_pad, int dv_pad, int split, int smem_kv, int smem_q,
    const void* strides, void* stream) {
  if (dq_dim > dq_pad || dv_dim > dv_pad || dq_dim < 1 || dv_dim < 1 ||
      n_kv < 1 || n_heads % n_kv != 0 || (dtype != 0 && dtype != 1) ||
      split < 1 || split > MAX_SPLIT || (n_heads / n_kv) % split != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = static_cast<const int64_t*>(strides);
  BwdParams p{q,      k,      v,       o,       dout,
              lse,    delta,  dq,      dk,      dv,
              t_len,  s_len,  n_heads, n_kv,    dq_dim,
              dv_dim, scale,  causal,  use_window, window,
              dtype,  vec,    split,  strides4(s), strides4(s + 4),
              strides4(s + 8),
              strides4(s + 12), strides4(s + 16), strides4(s + 20),
              strides4(s + 24), strides4(s + 28)};
  auto str = static_cast<cudaStream_t>(stream);
  const int rows = b * n_heads * t_len;
  const int per = DELTA_THREADS / 32;
  bwd_delta<<<(rows + per - 1) / per, DELTA_THREADS, 0, str>>>(p, b);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (dq_pad == 64 && dv_pad == 64)
    return launch_dims<64, 64>(dtype, b, p, smem_kv, smem_q, str);
  if (dq_pad == 128 && dv_pad == 128)
    return launch_dims<128, 128>(dtype, b, p, smem_kv, smem_q, str);
  if (dq_pad == 192 && dv_pad == 128)
    return launch_dims<192, 128>(dtype, b, p, smem_kv, smem_q, str);
  if (dq_pad == 256 && dv_pad == 256)
    return launch_dims<256, 256>(dtype, b, p, smem_kv, smem_q, str);
  return static_cast<int>(cudaErrorInvalidValue);
}
