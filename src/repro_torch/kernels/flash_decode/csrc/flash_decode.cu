// Single-token decode attention for Hopper: one kernel, split over the
// cache, merged inside a thread block cluster.
//
// Replaces the Pallas TPU kernel decode_attention_splits (_decode_kernel) in
// src/repro/kernels/flash_decode/flash_decode.py, and the logsumexp merge
// that src/repro/kernels/flash_decode/ops.py runs after it. Inputs:
// q (B,H,dq), the cache k (B,S,Hkv,dq) and v (B,S,Hkv,dv) in its own layout,
// read through strides (a layer's slice of the stacked cache, no copy), and
// valid (B,S) bytes. Query head h reads kv head h / g with g = H / Hkv.
//
// Bound on an H100: about 6 operations per cache byte, far below the
// tensor cores' crossover, so bytes bound it: the valid keys' K and V rows
// (8.4 MB at B = 8, S = 1024, Hkv = 2, d = 128, bf16 with every key valid:
// 2.5 us at 3.35 TB/s). What the design does about it:
//
// - Fewer bytes. A block reads its tiles' mask bytes first (a warp ballot
//   per 32 keys, the first batch in flight with q) and issues no K/V load
//   for a 64-key tile without a valid key; in a mixed tile the rows of
//   masked keys are zero-filled, not read. Device time follows the valid
//   length, not max_len. Masking stays exact per key: a masked key gets
//   weight 0, and a split with no valid key keeps m = -1e30, l = 0,
//   acc = 0 (flash_decode.py:38-41).
// - Bytes in flight. Tiles stay in their dtype in shared memory and arrive
//   16 bytes a thread by cp.async into a ring of 3 stages, so the next two
//   tiles load while this one is computed. Views whose rows cannot be copied
//   16 bytes at a time (the wrapper's `vec` bits) take element loads into
//   the same ring.
// - One launch. Grid (splits, Hkv, B); the splits of one (b, kv head) row
//   form one cluster (at most 8 blocks) and take the row's tiles
//   round-robin (tile t to split t % splits), so the valid prefix of a
//   serve slot spreads over all of them. Each block keeps its partial
//   (m, l, acc) in shared memory; after a cluster barrier the blocks merge
//   the partials through distributed shared memory, in split order, each a
//   slice of the outputs. No global scratch, no counters, no atomics: two
//   calls give bitwise equal results, and a CUDA graph may capture it. At
//   most 128 registers and (bf16, g <= 8) 110 KB of shared memory a block
//   keep two blocks an SM, so all clusters of the serve step are resident
//   at once.
// - Few shared-memory reads an operation, since a warp issues them at a
//   quarter of its FMA rate. bf16 logits run on the tensor cores
//   (mma.sync m16n8k16, q padded to 16 rows): bf16 x bf16 products are
//   exact in fp32 and are summed in fp32, so only the order of the sums
//   differs from fp32 on the CUDA cores, and the logits took 0.5 us a tile
//   where the CUDA cores took 1.8 (at g = 6). fp32 logits stay on the CUDA
//   cores. P V stays fp32 on the CUDA cores for both (the weights are not
//   rounded): a set of warps shares 8 heads and splits each tile's keys,
//   lane l owns DV / 32 columns, and one 16-byte read brings 4 keys'
//   weights of a head; the warps' sums are added in a fixed order at the
//   end. Softmax in base 2.
//
// Head dims are compile-time 64, 128 or 256 (zero-padded); groups up to 32.
// Head dims above 128 (gemma3's 256, its pruned dq 128 with dv 256): three
// stages of 64 keys no longer fit where the per-row footprint doubles (at
// 256/256 in bf16 they take 203 KB beside q and the logits; fp32 twice
// that), so each shape keeps as many stages (3, 2 or 1) as fit the 227 KB
// of a block, with the keys a tile unchanged: bf16 keeps three (229,792 of
// the 232,448 bytes at 256/256), fp32 128/256 two, fp32 256/128 and
// 256/256 one (the next tile loads after this one is computed). Such
// shapes keep one block an SM, which gives a thread up to 255 registers
// for its 8 heads x 8 columns of P V sums.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int TK = 64;            // keys per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 32;          // largest group of query heads per kv head
constexpr int GT = 128;           // tiles a block sorts into valid/empty at once
constexpr int MAX_SPLITS = 8;     // blocks of one (portable) cluster
constexpr float NEG = -1e30f;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have

// element strides: q (b, h, d), k (b, s, h, d), v (b, s, h, d), valid (b, s),
// o (b, h, d)
struct Strides {
  int64_t qb, qh, qd, kb, ks, kh, kd, vb, vs, vh, vd, mb, ms, ob, oh, od;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;
  void* o;
  int s_len, n_kv, g, dq, dv, ns, vec;   // vec: bit 0 k, bit 1 v
  float scale_log2;                      // scale * log2(e)
  Strides st;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; bytes < 16 reads that many and zero-fills the
// rest (0: the chunk is all zeros and nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// D += A B on the tensor cores: m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool key_ok(const uint32_t* bits, int r) {
  return (bits[r >> 5] >> (r & 31)) & 1u;
}

// shared memory: the ring (STAGES x (K tile, V tile) in T, rows padded by
// 16 bytes so that the fragment loads are free of bank conflicts), q (bf16:
// the tensor-core operand, q16 x LDK; fp32: gp x DQ; zero rows past g), the
// logits/weights (gp x TK), m, l and the rescale factor (GMAX each), the
// group's key bits (2 words a tile), its valid-tile list and warp counts.
// At the end the ring holds the warps' P V sums and then the split's
// partial acc. gp: g rounded up to the heads of the P V sets; q16: gp
// rounded up to the 16 rows of an mma.
template <typename T, int DQ, int DV>
struct Shape {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDK = DQ + PAD, LDV = DV + PAD;
  static constexpr int STAGE = TK * (LDK + LDV);   // elements a stage
  __host__ __device__ static constexpr int gp(int g) {
    return g <= 8 ? 8 : g <= 16 ? 16 : 32;
  }
  __host__ __device__ static constexpr int q_rows(int g) {
    return sizeof(T) == 2 && gp(g) < 16 ? 16 : gp(g);
  }
  __host__ __device__ static constexpr size_t q_bytes(int g) {
    return sizeof(T) == 2 ? (size_t)q_rows(g) * LDK * 2
                          : (size_t)gp(g) * DQ * 4;
  }
  __host__ __device__ static constexpr size_t rest(int g) {
    return q_bytes(g) + sizeof(float) * ((size_t)gp(g) * TK + 3 * GMAX)
           + sizeof(uint32_t) * 2 * GT + sizeof(int) * (GT + WARPS);
  }
  // cp.async ring depth: as many stages as fit beside the largest group's
  // q and logits
  static constexpr int STAGES =
      3 * STAGE * sizeof(T) + rest(GMAX) <= SMEM_MAX   ? 3
      : 2 * STAGE * sizeof(T) + rest(GMAX) <= SMEM_MAX ? 2
                                                        : 1;
  static constexpr int RING = STAGES * STAGE * (int)sizeof(T);
  static_assert(RING + rest(GMAX) <= SMEM_MAX, "one stage fits");
  static_assert(RING >= (WARPS * 8 + GMAX) * DV * 4,
                "the warp sums and the partial acc reuse the ring");
  // registers: 8 heads x DV / 32 columns of P V sums a thread
  static constexpr int MIN_BLOCKS = DQ > 128 || DV > 128 ? 1 : 2;
  __host__ __device__ static constexpr size_t bytes(int g) {
    return RING + rest(g);
  }
};

// The D columns of one tile's K or V rows (keys s0 .. s0 + 63) into a ring
// stage of row stride ld; rows of keys past s_len or masked are zero-filled
// without a read
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* p,
                                          int64_t sr, int64_t sd, int s0,
                                          int s_len, int d, bool vec,
                                          const uint32_t* bits, int tid) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CPR = D / E;              // 16-byte chunks a row
#pragma unroll
    for (int e = tid; e < TK * CPR; e += THREADS) {
      const int r = e / CPR, col = (e % CPR) * E;
      const int key = s0 + r;
      const bool in = key < s_len && col < d && key_ok(bits, r);
      const int bytes = in ? min(d - col, E) * (int)sizeof(T) : 0;
      cp_async16(dst + r * ld + col, in ? p + key * sr + col : p, bytes);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < TK * D; e += THREADS) {
      const int r = e / D, col = e % D;
      const int key = s0 + r;
      dst[r * ld + col] = (key < s_len && col < d && key_ok(bits, r))
                   ? p[key * sr + col * sd] : zero<T>();
    }
  }
}

template <typename T, int DQ, int DV>
__global__ void __launch_bounds__(THREADS, (Shape<T, DQ, DV>::MIN_BLOCKS))
flash_decode_kernel(const Params p) {
  using Sh = Shape<T, DQ, DV>;
  constexpr int STAGES = Sh::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = p.g, gp = Sh::gp(p.g);
  T* ring = reinterpret_cast<T*>(smem);
  T* qs = reinterpret_cast<T*>(smem + Sh::RING);
  float* ps = reinterpret_cast<float*>(smem + Sh::RING + Sh::q_bytes(g));
  float* m_s = ps + gp * TK;
  float* l_s = m_s + GMAX;
  float* c_s = l_s + GMAX;
  uint32_t* bits = reinterpret_cast<uint32_t*>(c_s + GMAX);
  int* list = reinterpret_cast<int*>(bits + 2 * GT);
  int* wcnt = list + GT;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int ns = p.ns, s_len = p.s_len;
  const Strides& st = p.st;
  const T* qp = static_cast<const T*>(p.q) + b * st.qb + (int64_t)hk * g * st.qh;
  const T* kp = static_cast<const T*>(p.k) + b * st.kb + hk * st.kh;
  const T* vp = static_cast<const T*>(p.v) + b * st.vb + hk * st.vh;
  const uint8_t* vm = p.valid + b * st.mb;
  const bool vec_k = p.vec & 1, vec_v = p.vec & 2;

  const int n_tiles = (s_len + TK - 1) / TK;
  const int mine = split < n_tiles ? (n_tiles - split + ns - 1) / ns : 0;
  // mask bytes of keys e0 + j THREADS + tid of the tile group at g0
  auto mask_bytes = [&](int g0, int nt, int e0, uint8_t (&mb)[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = e0 + j * THREADS + tid;
      const int key = (split + (g0 + e / TK) * ns) * TK + e % TK;
      mb[j] = e < nt * TK && key < s_len ? vm[(int64_t)key * st.ms] : 0;
    }
  };

  // q and the first mask bytes: every load issued before any store
  constexpr int QPT = GMAX * DQ / THREADS;
  T qv[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int e = tid + j * THREADS, h = e / DQ, d = e % DQ;
    qv[j] = h < g && d < p.dq ? qp[h * st.qh + d * st.qd] : zero<T>();
  }
  uint8_t mb[8];
  mask_bytes(0, min(GT, mine), 0, mb);
  constexpr int LDQ = sizeof(T) == 2 ? Sh::LDK : DQ;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int e = tid + j * THREADS, h = e / DQ, d = e % DQ;
    if (h < Sh::q_rows(g)) qs[h * LDQ + d] = qv[j];
  }
  if (tid < GMAX) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  // P V: the heads go in groups of 8 to 1, 2 or 4 sets of warps; the
  // warps of a set split each tile's keys, and lane l owns columns
  // CPT l .. CPT l + CPT - 1 of its 8 heads, summed in registers over all
  // tiles and over the set's warps at the end
  constexpr int CPT = DV / 32;
  const int sets = gp / 8;
  const int wps = WARPS / sets;                  // warps a set
  const int h8 = (warp / wps) * 8, kw = TK / wps;
  const int k0 = (warp % wps) * kw;              // this warp's keys
  float acc[8][CPT];
#pragma unroll
  for (int hh = 0; hh < 8; ++hh)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[hh][c] = 0.f;

  // logits: 8 lanes a key pair (kq, kq + 32), each 16-byte chunks part,
  // part + 8, ... of both keys
  constexpr int E = 16 / sizeof(T);
  constexpr int CPL = DQ / (8 * E);
  const int part = tid % 8, kq = tid / 8;

  for (int g0 = 0; g0 < mine; g0 += GT) {
    const int nt = min(GT, mine - g0);
    // key bits of the group's tiles: one ballot per 32 keys (nt * TK is a
    // multiple of 32, so every warp runs the loop whole), the mask bytes of
    // 8 passes loaded before any is used (the first batch came with q)
    for (int e0 = 0; e0 < nt * TK; e0 += 8 * THREADS) {
      if (g0 | e0) mask_bytes(g0, nt, e0, mb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = e0 + j * THREADS + tid;
        if (e < nt * TK) {      // whole warps: nt * TK is a multiple of 32
          const unsigned bal = __ballot_sync(0xffffffffu, mb[j] != 0);
          if (lane == 0) bits[e / 32] = bal;
        }
      }
    }
    __syncthreads();
    // the list of tiles with a valid key, in order
    bool has = false;
    unsigned bal = 0;
    if (tid < GT) {
      has = tid < nt && (bits[2 * tid] | bits[2 * tid + 1]) != 0;
      bal = __ballot_sync(0xffffffffu, has);
      if (lane == 0) wcnt[warp] = __popc(bal);
    }
    __syncthreads();
    int nv = 0, off = 0;
#pragma unroll
    for (int w = 0; w < GT / 32; ++w) {
      off += w < warp ? wcnt[w] : 0;
      nv += wcnt[w];
    }
    if (has) list[off + __popc(bal & ((1u << lane) - 1u))] = tid;
    __syncthreads();

    auto issue = [&](int i) {
      if (i < nv) {
        const int lt = list[i];
        const int s0 = (split + (g0 + lt) * ns) * TK;
        T* stage = ring + (i % STAGES) * Sh::STAGE;
        load_rows<T, DQ>(stage, Sh::LDK, kp, st.ks, st.kd, s0, s_len, p.dq,
                         vec_k, bits + 2 * lt, tid);
        load_rows<T, DV>(stage + TK * Sh::LDK, Sh::LDV, vp, st.vs, st.vd, s0,
                         s_len, p.dv, vec_v, bits + 2 * lt, tid);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) issue(i);

    for (int i = 0; i < nv; ++i) {
      if constexpr (STAGES == 1) {
        __syncthreads();      // tile i - 1 fully consumed: load tile i
        issue(i);
        cp_async_wait<0>();
        __syncthreads();      // tile i landed
      } else {
        cp_async_wait<STAGES - 2>();
        __syncthreads();      // tile i landed; tile i - 1 fully consumed
        issue(i + STAGES - 1);
      }
      const T* ks = ring + (i % STAGES) * Sh::STAGE;
      const T* vs = ks + TK * Sh::LDK;
      const uint32_t* tb = bits + 2 * list[i];

      // logits (gp, TK) in base 2
      if constexpr (sizeof(T) == 2) {
        // bf16: on the tensor cores, exact products and fp32 sums; warp w
        // takes keys 8 w .. 8 w + 7 (n) for 16 heads at a time (m)
        const int gid = lane >> 2, tig = lane & 3, key0 = warp * 8;
        const int kk = key0 + 2 * tig;
        const bool ok0 = key_ok(tb, kk), ok1 = key_ok(tb, kk + 1);
        for (int mt = 0; mt < gp; mt += 16) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < DQ; k += 16) {
            const T* qa = qs + (mt + gid) * Sh::LDK + k + 2 * tig;
            const uint32_t a[4] = {
                *reinterpret_cast<const uint32_t*>(qa),
                *reinterpret_cast<const uint32_t*>(qa + 8 * Sh::LDK),
                *reinterpret_cast<const uint32_t*>(qa + 8),
                *reinterpret_cast<const uint32_t*>(qa + 8 * Sh::LDK + 8)};
            const T* kb = ks + (key0 + gid) * Sh::LDK + k + 2 * tig;
            mma_bf16(d, a, *reinterpret_cast<const uint32_t*>(kb),
                     *reinterpret_cast<const uint32_t*>(kb + 8));
          }
          // d0, d1: head mt + gid, keys kk, kk + 1; d2, d3: head + 8
          if (mt + gid < gp) {
            ps[(mt + gid) * TK + kk] = ok0 ? d[0] * p.scale_log2 : NEG;
            ps[(mt + gid) * TK + kk + 1] = ok1 ? d[1] * p.scale_log2 : NEG;
          }
          if (mt + gid + 8 < gp) {
            ps[(mt + gid + 8) * TK + kk] = ok0 ? d[2] * p.scale_log2 : NEG;
            ps[(mt + gid + 8) * TK + kk + 1] = ok1 ? d[3] * p.scale_log2
                                                   : NEG;
          }
        }
      } else {
        // fp32: 4 heads x 2 keys a lane at a time on the CUDA cores
        const float* qf = reinterpret_cast<const float*>(qs);
        float k0f[CPL * E], k1f[CPL * E];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const float4 r0 = *reinterpret_cast<const float4*>(
              ks + kq * Sh::LDK + (part + 8 * c) * E);
          const float4 r1 = *reinterpret_cast<const float4*>(
              ks + (kq + 32) * Sh::LDK + (part + 8 * c) * E);
          k0f[c * E] = r0.x; k0f[c * E + 1] = r0.y;
          k0f[c * E + 2] = r0.z; k0f[c * E + 3] = r0.w;
          k1f[c * E] = r1.x; k1f[c * E + 1] = r1.y;
          k1f[c * E + 2] = r1.z; k1f[c * E + 3] = r1.w;
        }
        const bool ok = key_ok(tb, kq + (part >> 2) * 32);
        for (int h0 = 0; h0 < gp; h0 += 4) {
          float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < CPL; ++c)
#pragma unroll
            for (int hh = 0; hh < 4; ++hh) {
              const float4 q4 = *reinterpret_cast<const float4*>(
                  qf + (h0 + hh) * DQ + (part + 8 * c) * E);
              const int x = c * E;
              s0[hh] = fmaf(q4.x, k0f[x], s0[hh]);
              s0[hh] = fmaf(q4.y, k0f[x + 1], s0[hh]);
              s0[hh] = fmaf(q4.z, k0f[x + 2], s0[hh]);
              s0[hh] = fmaf(q4.w, k0f[x + 3], s0[hh]);
              s1[hh] = fmaf(q4.x, k1f[x], s1[hh]);
              s1[hh] = fmaf(q4.y, k1f[x + 1], s1[hh]);
              s1[hh] = fmaf(q4.z, k1f[x + 2], s1[hh]);
              s1[hh] = fmaf(q4.w, k1f[x + 3], s1[hh]);
            }
#pragma unroll
          for (int o = 4; o > 0; o >>= 1)
#pragma unroll
            for (int hh = 0; hh < 4; ++hh) {
              s0[hh] += __shfl_xor_sync(0xffffffffu, s0[hh], o);
              s1[hh] += __shfl_xor_sync(0xffffffffu, s1[hh], o);
            }
          // lane part writes head h0 + part % 4 of key kq (part < 4) or
          // kq + 32
          float sv = 0.f;
#pragma unroll
          for (int hh = 0; hh < 4; ++hh)
            if ((part & 3) == hh) sv = part < 4 ? s0[hh] : s1[hh];
          ps[(h0 + (part & 3)) * TK + kq + (part >> 2) * 32] =
              ok ? sv * p.scale_log2 : NEG;
        }
      }
      __syncthreads();

      // online softmax: one warp a head; masked keys weigh exactly 0
      for (int h = warp; h < g; h += WARPS) {
        float* pr = ps + h * TK;
        const float x0 = pr[lane], x1 = pr[lane + 32];
        const bool ok0 = (tb[0] >> lane) & 1u, ok1 = (tb[1] >> lane) & 1u;
        const float m_prev = m_s[h];
        const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
        const float p0 = ok0 ? exp2f(x0 - m_new) : 0.f;
        const float p1 = ok1 ? exp2f(x1 - m_new) : 0.f;
        pr[lane] = p0;
        pr[lane + 32] = p1;
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float corr = exp2f(m_prev - m_new);
          l_s[h] = l_s[h] * corr + sum;
          m_s[h] = m_new;
          c_s[h] = corr;
        }
      }
      __syncthreads();

      // acc (8 heads, CPT columns) += P V over this warp's keys, 4 at a time
#pragma unroll
      for (int hh = 0; hh < 8; ++hh) {
        const float corr = h8 + hh < g ? c_s[h8 + hh] : 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[hh][c] *= corr;
      }
      for (int r = k0; r < k0 + kw; r += 4) {
        float vf[4][CPT];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T* vr = vs + (r + j) * Sh::LDV + lane * CPT;
          if constexpr (sizeof(T) == 2) {
            if constexpr (CPT % 4 == 0) {       // 4 columns an 8-byte read
#pragma unroll
              for (int c = 0; c < CPT; c += 4) {
                const uint2 raw = *reinterpret_cast<const uint2*>(vr + c);
                const float2 a = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
                const float2 b2 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
                vf[j][c] = a.x; vf[j][c + 1] = a.y;
                vf[j][c + 2] = b2.x; vf[j][c + 3] = b2.y;
              }
            } else {
              const float2 a = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(vr));
              vf[j][0] = a.x; vf[j][1] = a.y;
            }
          } else {
            if constexpr (CPT % 4 == 0) {       // 4 columns a 16-byte read
#pragma unroll
              for (int c = 0; c < CPT; c += 4) {
                const float4 a = *reinterpret_cast<const float4*>(vr + c);
                vf[j][c] = a.x; vf[j][c + 1] = a.y;
                vf[j][c + 2] = a.z; vf[j][c + 3] = a.w;
              }
            } else {
              const float2 a = *reinterpret_cast<const float2*>(vr);
              vf[j][0] = a.x; vf[j][1] = a.y;
            }
          }
        }
#pragma unroll
        for (int hh = 0; hh < 8; ++hh) {
          const float4 w = *reinterpret_cast<const float4*>(
              ps + (h8 + hh) * TK + r);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            float a = acc[hh][c];
            a = fmaf(w.x, vf[0][c], a);
            a = fmaf(w.y, vf[1][c], a);
            a = fmaf(w.z, vf[2][c], a);
            a = fmaf(w.w, vf[3][c], a);
            acc[hh][c] = a;
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();          // the ring, bits and list are free again
  }

  // this split's partial: m and l stay where they are; the warps of each
  // set add their sums in a fixed order into acc (g, DV) in the ring
  float* red = reinterpret_cast<float*>(ring);    // (WARPS, 8, DV)
#pragma unroll
  for (int hh = 0; hh < 8; ++hh)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      red[(warp * 8 + hh) * DV + lane * CPT + c] = acc[hh][c];
  __syncthreads();
  float* accs = red + WARPS * 8 * DV;             // (g, DV)
  for (int e = tid; e < g * DV; e += THREADS) {
    const int h = e / DV, c = e % DV;
    const int w0 = (h / 8) * wps;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (w < wps) a += red[((w0 + w) * 8 + h % 8) * DV + c];
    accs[e] = a;
  }
  cluster.sync();

  // merge the cluster's ns partials in split order: block r of the cluster
  // writes outputs r * THREADS + tid, stepping ns * THREADS, with all its
  // reads of the other blocks' m, l and acc in flight together
  const int rank = static_cast<int>(cluster.block_rank());
  T* op = static_cast<T*>(p.o) + b * st.ob + (int64_t)hk * g * st.oh;
  for (int e = rank * THREADS + tid; e < g * p.dv; e += ns * THREADS) {
    const int h = e / p.dv, c = e % p.dv;
    float ms[MAX_SPLITS], ls[MAX_SPLITS], as[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      const bool in = s < ns;
      ms[s] = in ? cluster.map_shared_rank(m_s, s)[h] : NEG;
      ls[s] = in ? cluster.map_shared_rank(l_s, s)[h] : 0.f;
      as[s] = in ? cluster.map_shared_rank(accs, s)[h * DV + c] : 0.f;
    }
    float mx = NEG;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) mx = fmaxf(mx, ms[s]);
    float l_tot = 0.f, a_tot = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < ns) {
        const float corr = exp2f(ms[s] - mx);
        l_tot = fmaf(ls[s], corr, l_tot);
        a_tot = fmaf(as[s], corr, a_tot);
      }
    store(op + h * st.oh + c * st.od, a_tot / fmaxf(l_tot, 1e-30f));
  }
  cluster.sync();             // no block leaves while another reads it
}

template <typename T, int DQ, int DV>
int launch(const Params& p, int b, cudaStream_t stream) {
  using Sh = Shape<T, DQ, DV>;
  auto kern = flash_decode_kernel<T, DQ, DV>;
  // once per instance and process (a thread-safe static initialiser)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::bytes(GMAX)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ns, p.n_kv, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Sh::bytes(p.g);
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = p.ns;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Params& p, int b, cudaStream_t s) {
  if (p.dq > 128 || p.dv > 128) {   // both padded to 128 or 256
    if (p.dq <= 128) return launch<T, 128, 256>(p, b, s);
    return p.dv <= 128 ? launch<T, 256, 128>(p, b, s)
                       : launch<T, 256, 256>(p, b, s);
  }
  if (p.dq <= 64)
    return p.dv <= 64 ? launch<T, 64, 64>(p, b, s) : launch<T, 64, 128>(p, b, s);
  return p.dv <= 64 ? launch<T, 128, 64>(p, b, s) : launch<T, 128, 128>(p, b, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); valid: bytes,
// nonzero = key may be attended. ns: splits (blocks of one cluster, 1..8,
// at most ceil(s_len / 64)); split t takes tiles t, t + ns, ... vec: bit 0
// (k), bit 1 (v) set when that tensor's rows may be copied 16 bytes at a
// time (last stride 1, other strides and base 16-byte aligned). strides: 16
// int64 element strides, (b, h, d) of q, (b, s, h, d) of k and v, (b, s) of
// valid, (b, h, d) of o. Requires 1 <= dq, dv <= 256, n_heads % n_kv == 0,
// n_heads / n_kv <= 32, s_len >= 1 (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_decode(int dtype, const void* q, const void* k,
                                  const void* v, const void* valid, void* o,
                                  int b, int s_len, int n_heads, int n_kv,
                                  int dq, int dv, int ns, float scale, int vec,
                                  const void* strides, void* stream) {
  if (dq < 1 || dv < 1 || dq > 256 || dv > 256 || n_kv < 1 ||
      n_heads % n_kv != 0 || n_heads / n_kv > GMAX || s_len < 1 || ns < 1 ||
      ns > MAX_SPLITS || ns > (s_len + TK - 1) / TK || b < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = static_cast<const int64_t*>(strides);
  const Params p{q, k, v, static_cast<const uint8_t*>(valid), o, s_len,
                 n_kv, n_heads / n_kv, dq, dv, ns, vec,
                 scale * 1.4426950408889634f,
                 Strides{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6],  s[7],
                         s[8], s[9], s[10], s[11], s[12], s[13], s[14],
                         s[15]}};
  auto str = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, b, str);
  if (dtype == 1) return launch_d<bf16>(p, b, str);
  return static_cast<int>(cudaErrorInvalidValue);
}
