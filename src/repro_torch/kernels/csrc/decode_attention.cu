// flash_decode for Hopper (sm_90a): one query token per sequence against a
// KV cache, over each sequence's valid prefix (slot < lengths[b]), with the
// cache split across blocks (split-KV) and a deterministic combine in the
// same launch.
//
// Replaces the Pallas TPU kernel `flash_decode` in
// src/repro/kernels/decode_attention.py (function at line 73, its
// pl.pallas_call at line 89, body `_decode_kernel` at line 35).  It computes
// what that kernel computes: scores q.k * scale, masked slots at -1e30, an
// online softmax carried in float32 across cache tiles, and the output
// acc / max(l, 1e-30) in the input's type.  A row whose length is <= 0 has
// no valid slot and averages over every slot, as the TPU kernel does;
// callers clamp lengths to >= 1.
//
// One bound more than the TPU kernel: a sliding `window` (0 = none) also
// masks the slots below lengths[b] - window, which with lengths = pos + 1
// is the reference LM's linear-cache window mask `idx > pos - window`
// (src/repro/models/layers/attention.py, attn_decode).  The window start is
// computed here, from the lengths on the device: the split plan stays a
// function of the shape alone.  A split wholly before the window start is
// empty like a split past the prefix.  A row whose window lies wholly past
// the cache has no valid slot and averages over every slot.
//
// Layout: q (B, H, D), caches (B, S, Hkv, D), all addressed through element
// strides with the last dimension contiguous and rows 16-byte aligned.  The
// Marian decoder keeps its caches as (B, T, H*D) with the heads folded in;
// the wrapper hands that buffer over as a strided (B, T, H, D) view, so
// nothing is transposed or copied per step.  GQA: the query heads of one kv
// head share every K/V row a block loads (up to 16 heads per block on the
// tensor cores, 8 on the CUDA cores; more heads take more blocks).
//
// What bounds it on this card: HBM bytes.  Per call it must read the valid
// prefix of K and V once (2 * B * len * Hkv * D elements) and q, and write
// the output; the two dot products are ~0.5 FLOP per byte read per query
// head.  At the serving shapes (B = 1-8, len <= 256) that stream is 0.1-4
// MB, 0.03-1.3 us at 3.35 TB/s, so what is left is latency: the launch, a
// round of loads, and the combine's round trips through L2.
//
// Design (one launch a call):
//   * Split-KV.  Grid (B * Hkv * head groups, n_split): split i covers slots
//     [i * chunk, (i + 1) * chunk) of the capacity S.  The wrapper plans
//     (n_split, chunk) from B * Hkv and S alone (about two waves on 132
//     SMs, >= 32 slots a split), never from `lengths`, which live on the
//     device: the plan costs the host no sync and a captured CUDA graph
//     stays right when lengths change.  The splits that hold a row's
//     valid slots are a range the blocks compute from lengths[b] and the
//     window; a split outside it (wholly past the prefix or before the
//     window start) returns at once, and a row with one live split has
//     its output written by that block alone.
//   * Two paths for a block's slots, chosen by the wrapper's plan
//     (decode_path, a pure function of rep = H / Hkv, D and the dtype, from
//     chip_smoke.py phase 6's sweep of both): in bf16, and in float32 from
//     rep = 3, the tensor cores; else the CUDA cores.
//   * Tensor cores: the group's query heads are the 16 M rows of mma.sync
//     tiles (padded with zero rows), slots the N columns.  q.K^T runs on
//     m16n8k16 (bf16) or m16n8k8 as 3 x TF32 (float32) over tiles of 8
//     slots taken by the 4 warps in turn; P.V on m16n8k8, P as hi + lo
//     bf16 pairs (bf16) or 3 x TF32 with fresh accumulators added to O in
//     float32 (float32).  Every operand goes from device memory as 16-byte
//     vectors straight into fragments, with no shared memory: the reduction
//     index of q.K^T is permuted alike in q and K, and P.V's output columns
//     are permuted so a lane's V loads are whole 16 bytes of a row.
//   * CUDA cores: the lanes of a row split D into 16-byte loads (a float32
//     row of 64 is 16 lanes x float4, a bf16 row 8 lanes), so a warp reads
//     32 / lanes-per-row slots at once, four such steps unrolled so their
//     loads are in flight together; dots reduce by shuffles within the
//     row's lanes; each lane group keeps its own online softmax.
//   * A block merges its warps' (m, l, acc) in warp order through shared
//     memory.  The only live split writes the output.  Otherwise it writes
//     its partial to scratch that the wrapper allocates with the output,
//     then adds one to its head group's counter with one atomic of release
//     and acquire semantics at device scope; the block that brings the
//     count to the number of live splits is the last, resets the counter
//     to 0 for the next call, and combines the live splits in split order
//     (weights exp(m - max) per split, the normaliser by a fixed
//     butterfly, each output folded over the splits in order, the first
//     loads issued before the weights are known).  No order depends on
//     which block is last, so two calls on the same inputs give
//     bitwise-equal outputs.  The counters belong to the wrapper
//     (split_counters: one zeroed buffer per device, a region per stream,
//     never reallocated under graph capture).  A split of masked slots
//     only (length <= 0: every split is live) carries m = -1e30 and its
//     slot count, so length <= 0 still averages over every slot.
//   * Softmax state out.  Given `stats_m` / `stats_l` (B * H float32 each),
//     the kernel also writes each (b, h) row's score maximum m and
//     normaliser l = sum exp(s - m), from the combine with splits and from
//     the block's own merge with one.  A caller that splits the cache
//     across ranks (sequence-sharded decode) merges the ranks' outputs
//     with them: weights l * exp(m - max m).  A row with no valid slot
//     carries m = -1e30, so its weight is 0 beside any live row.
//
// What it still leaves for later: TMA or bulk copies of whole cache tiles
// (16-byte loads straight into fragments keep one round of loads per
// tile); the tensor-core path with 4 busy warps also at 32-slot splits of
// float32 D = 128 (255 registers there); a persistent kernel over all
// layers of a decode step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;         // slot steps per warp whose loads overlap
constexpr int kMmaHeads = 16;      // tensor-core path: heads of one mma tile
constexpr float kMasked = -1e30f;  // score of a masked slot (NEG_INF there)

using repro::FragA;
using repro::FragB;
using repro::mma_3xtf32;

// 16 bytes of T as float32 values
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float4 fma4(float4 x, float w, float4 a) {
  return make_float4(fmaf(x.x, w, a.x), fmaf(x.y, w, a.y), fmaf(x.z, w, a.z),
                     fmaf(x.w, w, a.w));
}
__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}
// four consecutive outputs
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// Fold (m2, l2, a2) into (m, l, a): the two-way online-softmax merge.
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float m2,
                                      float l2, const float* a2) {
  const float mx = fmaxf(m, m2);
  const float s1 = expf(m - mx), s2 = expf(m2 - mx);
  l = l * s1 + l2 * s2;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * s1 + a2[e] * s2;
  m = mx;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A block's slot range and heads.
struct Split {
  int b, g, h0, nh;  // batch row, kv head, first query head, heads served
  int lo, hi;        // slots [lo, hi) of this split (empty when lo >= hi)
  bool masked;       // the row has no valid slot: every score is -1e30
};

constexpr int kMaxSplits = 264;    // the plan's most: 2 waves of 132 SMs

// Each warp's softmax state of the block's heads, handed to the block
// merge; the last block's combine reuses the space for the splits' weights.
template <int RB, int D>
struct Partial {
  union {
    float acc[kWarps][RB][D];
    float wts[RB][kMaxSplits];
  };
  float ml[kWarps][RB][2];
};

// ---- CUDA-core path: lanes split D into 16-byte loads, dots by shuffles --
// (the slot loop of PR 13's kernel: a warp reads 32 / lanes-per-row slots
// at once, kUnroll steps in flight; each lane group keeps its own online
// softmax, merged by shuffles at the end)
template <typename T, int D, int RB>
__device__ __forceinline__ void cores_part(
    const Split& sp, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, Partial<RB, D>& part) {
  constexpr int EPL = Vec<T>::N;  // elements per lane (16 bytes)
  constexpr int LPR = D / EPL;    // lanes per cache row
  constexpr int SPW = 32 / LPR;   // slots a warp reads per step
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR, pt = lane % LPR;

  float qv[RB][EPL], m[RB], l[RB], acc[RB][EPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < sp.nh)
      Vec<T>::load(q + sp.b * q_sb + (int64_t)(sp.h0 + r) * q_sh + pt * EPL,
                   qv[r]);
    else
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[r][e] = 0.f;
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const T* kb = k + sp.b * k_sb + (int64_t)sp.g * k_sh + pt * EPL;
  const T* vb = v + sp.b * v_sb + (int64_t)sp.g * v_sh + pt * EPL;
  for (int base = sp.lo + warp * SPW * kUnroll; base < sp.hi;
       base += kWarps * SPW * kUnroll) {
    float kx[kUnroll][EPL], vx[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = base + u * SPW + sub;
      ok[u] = slot < sp.hi;
      if (ok[u]) {
        Vec<T>::load(kb + (int64_t)slot * k_ss, kx[u]);
        Vec<T>::load(vb + (int64_t)slot * v_ss, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kx[u][e] = vx[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float s[kUnroll];
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qv[r][e], kx[u][e], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        // past the split: no weight at all; no valid slot: masked
        s[u] = !ok[u] ? -INFINITY : (sp.masked ? kMasked : dot * scale);
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[r] - mx);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(s[u] - mx);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p, vx[u][e], acc[r][e]);
      }
      m[r] = mx;
    }
  }

  // lane groups of a warp by shuffles, in order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float a2[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        a2[e] = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      merge<EPL>(m[r], l[r], acc[r], m2, l2, a2);
    }
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) part.acc[warp][r][pt * EPL + e] = acc[r][e];
      if (lane == 0) part.ml[warp][r][0] = m[r], part.ml[warp][r][1] = l[r];
    }
  }
}

// ---- tensor-core path: the group's query heads are the M rows of mma ----
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x0, x1) = hi + lo as packed bf16 pairs: P keeps ~16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}
__device__ __forceinline__ uint4 load16(const void* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ uint32_t word(const uint4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Scores of one tile: scale, or -1e30 when the row has no valid slot, or
// -inf past the split; then the online softmax of rows g (e = 0, 1) and
// g + 8 (e = 2, 3) over the tile's columns, `o` rescaled.  `slot0` is the
// slot of column 2t of chunk 0; chunk j adds 8j.
template <int NC, int NO>
__device__ __forceinline__ void tile_softmax(float (*sc)[4], int slot0,
                                             const Split& sp, float scale,
                                             float* m, float* l,
                                             float (*o)[4]) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = slot0 + 8 * j + (e & 1);
      sc[j][e] = slot >= sp.hi ? -INFINITY
                               : (sp.masked ? kMasked : sc[j][e] * scale);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      mx = fmaxf(mx, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
    const float m_new = fmaxf(m[i], quad_max(mx));
    const float alpha = expf(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const float p = expf(sc[j][e] - m_new);
        sc[j][e] = p;
        sum += p;
      }
    l[i] = alpha * l[i] + sum;
    m[i] = m_new;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * i] *= alpha;
      o[n][2 * i + 1] *= alpha;
    }
  }
}

// bfloat16: tiles of 8 slots (one n-tile of q.K^T, one k8 step of P.V),
// taken by the warps in turn.  Every operand comes from device memory as
// 16-byte vectors straight into fragments: the reduction index of q.K^T is
// permuted (lane t holds head dims 32c + 8t .. + 7 for k-steps 2c and
// 2c + 1, in q and K alike), and P.V's output columns are permuted (lane g
// loads head dims 64c + 8g .. + 7 of V rows 2t and 2t + 1 and packs slot
// pairs with byte permutes), so no shared memory is needed.
__device__ __forceinline__ void mma_bf16_k8(float* c, const uint32_t* a,
                                            uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

template <int D>
__device__ __forceinline__ void mma_part_bf16(
    const Split& sp, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
    Partial<kMmaHeads, D>& part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  uint4 qa[D / 32][2];  // rows gq and gq + 8
#pragma unroll
  for (int c = 0; c < D / 32; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qa[c][i] = load16(q + sp.b * q_sb + (int64_t)(sp.h0 + gq + 8 * i) * q_sh +
                            32 * c + 8 * tq,
                        gq + 8 * i < sp.nh);
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float o[D / 8][4];  // n-tile 8c + i: head dim 64c + 8g + i
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const __nv_bfloat16* kb = k + sp.b * k_sb + (int64_t)sp.g * k_sh;
  const __nv_bfloat16* vb = v + sp.b * v_sb + (int64_t)sp.g * v_sh;
  for (int base = sp.lo + 8 * warp; base < sp.hi; base += 8 * kWarps) {
    uint4 kx[D / 32], vx[2][D / 64];
    {
      const int slot = base + gq;
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
        kx[c] = load16(kb + (int64_t)slot * k_ss + 32 * c + 8 * tq,
                       slot < sp.hi);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // slots 2t and 2t + 1
      const int slot = base + 2 * tq + r;
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        vx[r][c] = load16(vb + (int64_t)slot * v_ss + 64 * c + 8 * gq,
                          slot < sp.hi);
    }
    float sc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      const uint32_t a0[4] = {qa[c][0].x, qa[c][1].x, qa[c][0].y, qa[c][1].y};
      const uint32_t b0[2] = {kx[c].x, kx[c].y};
      mma_bf16(sc[0], a0, b0);
      const uint32_t a1[4] = {qa[c][0].z, qa[c][1].z, qa[c][0].w, qa[c][1].w};
      const uint32_t b1[2] = {kx[c].z, kx[c].w};
      mma_bf16(sc[0], a1, b1);
    }
    tile_softmax<1, D / 8>(sc, base + 2 * tq, sp, scale, m, l, o);
    uint32_t ph[2], pl[2];  // the C fragment is the k8 step's A fragment
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t bv = __byte_perm(word(vx[0][c], i / 2),
                                        word(vx[1][c], i / 2),
                                        (i & 1) ? 0x7632 : 0x5410);
        mma_bf16_k8(o[8 * c + i], pl, bv);
        mma_bf16_k8(o[8 * c + i], ph, bv);
      }
  }
  // C column 2t + e of n-tile 8c + i is head dim 64c + 16t + 8e + i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    const int r = gq + 8 * i;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part.acc[warp][r][64 * c + 16 * tq + 8 * e + n] =
              o[8 * c + n][2 * i + e];
    if (tq == 0) part.ml[warp][r][0] = m[i], part.ml[warp][r][1] = l[i];
  }
}

// float32: tiles of 8 slots, 3 x TF32.  Lane t holds head dims 16c + 4t ..
// + 3 of q and K for k-steps 2c, 2c + 1; the S accumulator's columns (2t,
// 2t + 1) feed P.V's k indices (t, t + 4), so lane t loads V rows 2t and
// 2t + 1 (head dims 32c + 4g .. + 3: output columns permuted).  Each
// 32-column slice of P.V sums in fresh accumulators added to O in float32.
template <int D>
__device__ __forceinline__ void mma_part_f32(
    const Split& sp, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, Partial<kMmaHeads, D>& part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  float4 qf[D / 16][2];
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 x = load16(q + sp.b * q_sb +
                                 (int64_t)(sp.h0 + gq + 8 * i) * q_sh +
                                 16 * c + 4 * tq,
                             gq + 8 * i < sp.nh);
      qf[c][i] = make_float4(__uint_as_float(x.x), __uint_as_float(x.y),
                             __uint_as_float(x.z), __uint_as_float(x.w));
    }
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float o[D / 8][4];  // n-tile 4c + i: head dim 32c + 4g + i
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const float* kb = k + sp.b * k_sb + (int64_t)sp.g * k_sh;
  const float* vb = v + sp.b * v_sb + (int64_t)sp.g * v_sh;
  for (int base = sp.lo + 8 * warp; base < sp.hi; base += 8 * kWarps) {
    float4 kf[D / 16], vf[2][D / 32];
    {
      const int slot = base + gq;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 x =
            load16(kb + (int64_t)slot * k_ss + 16 * c + 4 * tq, slot < sp.hi);
        kf[c] = make_float4(__uint_as_float(x.x), __uint_as_float(x.y),
                            __uint_as_float(x.z), __uint_as_float(x.w));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int slot = base + 2 * tq + r;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const uint4 x =
            load16(vb + (int64_t)slot * v_ss + 32 * c + 4 * gq, slot < sp.hi);
        vf[r][c] = make_float4(__uint_as_float(x.x), __uint_as_float(x.y),
                               __uint_as_float(x.z), __uint_as_float(x.w));
      }
    }
    float sc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      FragA a;
      FragB bk;
      a.set(qf[c][0].x, qf[c][1].x, qf[c][0].y, qf[c][1].y);
      bk.set(kf[c].x, kf[c].y);
      mma_3xtf32(sc[0], a, bk);
      a.set(qf[c][0].z, qf[c][1].z, qf[c][0].w, qf[c][1].w);
      bk.set(kf[c].z, kf[c].w);
      mma_3xtf32(sc[0], a, bk);
    }
    tile_softmax<1, D / 8>(sc, base + 2 * tq, sp, scale, m, l, o);
    FragA pa;  // k index t <-> slot 2t, t + 4 <-> slot 2t + 1
    pa.set(sc[0][0], sc[0][2], sc[0][1], sc[0][3]);
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      const float v0[4] = {vf[0][c].x, vf[0][c].y, vf[0][c].z, vf[0][c].w};
      const float v1[4] = {vf[1][c].x, vf[1][c].y, vf[1][c].z, vf[1][c].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        FragB bv;
        bv.set(v0[i], v1[i]);
        mma_3xtf32(f, pa, bv);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * c + i][e] += f[e];
      }
    }
  }
  // C column 2t + e of n-tile 4c + i is head dim 32c + 8t + 4e + i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    const int r = gq + 8 * i;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part.acc[warp][r][32 * c + 8 * tq + 4 * e + n] =
              o[4 * c + n][2 * i + e];
    if (tq == 0) part.ml[warp][r][0] = m[i], part.ml[warp][r][1] = l[i];
  }
}

// One launch a call.  Grid (B * Hkv * head groups, n_split).  Each block
// forms its split's softmax state for its heads (on the tensor cores when
// kMma, else on the CUDA cores), merges its warps in order, and then: with
// one split writes the output; otherwise writes its partial (m, l, acc) to
// scratch, and the block that finds itself last on the group's counter
// combines every split in split order and resets the counter.
template <typename T, int D, int RB, bool kMma>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml,
                        float* __restrict__ stats_m,
                        float* __restrict__ stats_l, int* __restrict__ counters,
                        int S, int Hkv, int rep, int n_groups, int n_split,
                        int chunk, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                        int64_t k_ss, int64_t k_sh, int64_t v_sb,
                        int64_t v_ss, int64_t v_sh, int64_t o_sb,
                        int64_t o_sh, float scale, int window) {
  __shared__ __align__(16) Partial<RB, D> part;
  __shared__ float blk_ml[RB][2];  // the block's (m, l), then the combine's
  __shared__ float wsc[RB][kWarps];
  __shared__ int is_last;

  const int hgrp = blockIdx.x % n_groups;
  const int bg = blockIdx.x / n_groups;
  const int split = blockIdx.y;
  const int H = Hkv * rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int Q4 = D / 4;  // groups of 4 head dims

  Split sp;
  sp.g = bg % Hkv;
  sp.b = bg / Hkv;
  const int len = lengths[sp.b];
  // Valid slots are [w_lo, min(len, S)), w_lo = len - window with a window.
  // With one valid slot or more the others carry zero weight and are not
  // visited; with none (len <= 0, or the window past the cache) every slot
  // is masked and all S are visited.
  const int w_lo = window > 0 ? max(0, len - window) : 0;
  sp.masked = len <= 0 || w_lo >= min(len, S);
  const int n_slots = sp.masked ? S : min(len, S);
  const int v_lo = sp.masked ? 0 : w_lo;  // the row's slots: [v_lo, n_slots)
  sp.lo = max(split * chunk, v_lo);
  sp.hi = min(split * chunk + chunk, n_slots);
  sp.h0 = sp.g * rep + hgrp * RB;        // first query head of the block
  sp.nh = min(RB, rep - hgrp * RB);      // heads this block serves
  // The splits that hold one of the row's slots, [first, last]: the others
  // are empty and carry nothing; one live split writes the output itself.
  const int first = v_lo / chunk, last = (n_slots - 1) / chunk;
  if (split < first || split > last) return;
  const int n_live = last - first + 1;

  {
    if constexpr (kMma) {
      if constexpr (sizeof(T) == 4)
        mma_part_f32<D>(sp, q, k, v, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                        v_sh, scale, part);
      else
        mma_part_bf16<D>(sp, q, k, v, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb,
                         v_ss, v_sh, scale, part);
    } else {
      cores_part<T, D, RB>(sp, q, k, v, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb,
                           v_ss, v_sh, scale, part);
    }
    __syncthreads();
    // the warps' states merged in warp order: each row's weights first
    if (threadIdx.x < sp.nh) {
      const int r = threadIdx.x;
      float mx = part.ml[0][r][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, part.ml[w][r][0]);
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float sw = expf(part.ml[w][r][0] - mx);
        wsc[r][w] = sw;
        l += part.ml[w][r][1] * sw;
      }
      blk_ml[r][0] = mx, blk_ml[r][1] = l;
    }
    __syncthreads();
    // each thread owns its (r, 4 head dims) from here to the partial's
    // write
    for (int i = threadIdx.x; i < sp.nh * Q4; i += kThreads) {
      const int r = i / Q4, d = 4 * (i % Q4);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        a = fma4(*reinterpret_cast<const float4*>(&part.acc[w][r][d]),
                 wsc[r][w], a);
      *reinterpret_cast<float4*>(&part.acc[0][r][d]) = a;
    }
  }

  if (n_live == 1) {
    for (int i = threadIdx.x; i < sp.nh * Q4; i += kThreads) {
      const int r = i / Q4, d = 4 * (i % Q4);
      const float inv = 1.f / fmaxf(blk_ml[r][1], 1e-30f);
      store4(out + sp.b * o_sb + (int64_t)(sp.h0 + r) * o_sh + d,
             scale4(*reinterpret_cast<const float4*>(&part.acc[0][r][d]),
                    inv));
      if (stats_m != nullptr && d == 0) {
        stats_m[(int64_t)sp.b * H + sp.h0 + r] = blk_ml[r][0];
        stats_l[(int64_t)sp.b * H + sp.h0 + r] = blk_ml[r][1];
      }
    }
    return;
  }

  // this split's partial
  const int64_t row0 = (int64_t)sp.b * H + sp.h0;  // the block's first head
  for (int i = threadIdx.x; i < sp.nh * Q4; i += kThreads) {
    const int r = i / Q4, d = 4 * (i % Q4);
    const int64_t idx = (row0 + r) * n_split + split;
    *reinterpret_cast<float4*>(part_acc + idx * D + d) =
        *reinterpret_cast<const float4*>(&part.acc[0][r][d]);
    if (d == 0)
      part_ml[2 * idx] = blk_ml[r][0], part_ml[2 * idx + 1] = blk_ml[r][1];
  }
  // the block's writes, then the count: one atomic with release and
  // acquire semantics at device scope
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counters + blockIdx.x)
                 : "memory");
    is_last = prev == n_live - 1;
    if (is_last) counters[blockIdx.x] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!is_last) return;

  // The last block combines the live splits in split order.  Each thread
  // owns up to kQ (r, 4 head dims) groups and folds them over the splits
  // in order, four splits at a time with all their loads in flight; the
  // first four are loaded before the weights are known.  Meanwhile one
  // warp per head reads the splits' (m, l), finds the largest m, writes
  // each split's weight exp(m - max) to shared memory and sums the
  // normaliser by a fixed butterfly.
  constexpr int kQ = (RB * Q4 + kThreads - 1) / kThreads;
  constexpr int kJ = 4;  // splits a round
  float4 acc[kQ], x[kQ][kJ];
  auto load_round = [&](int j0) {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      const int i = threadIdx.x + qi * kThreads;
      const int r = i / Q4, d = 4 * (i % Q4);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        x[qi][j] = i < sp.nh * Q4 && j0 + j < n_live
                       ? __ldcg(reinterpret_cast<const float4*>(
                             part_acc +
                             ((row0 + r) * n_split + first + j0 + j) * D + d))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_round(0);
  constexpr int kRegs = (kMaxSplits + 31) / 32;
  for (int r = warp; r < sp.nh; r += kWarps) {
    const float* ml = part_ml + ((row0 + r) * n_split + first) * 2;
    float mv[kRegs], lv[kRegs];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kRegs; ++c) {
      const int i = lane + 32 * c;
      mv[c] = i < n_live ? __ldcg(ml + 2 * i) : -INFINITY;
      lv[c] = i < n_live ? __ldcg(ml + 2 * i + 1) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kRegs; ++c) mx = fmaxf(mx, mv[c]);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < kRegs; ++c) {
      if (32 * c >= n_live) break;
      const float w = lane + 32 * c < n_live ? expf(mv[c] - mx) : 0.f;
      float lw = lv[c] * w;
      if (lane + 32 * c < n_live) part.wts[r][lane + 32 * c] = w;
      for (int o = 16; o > 0; o >>= 1)
        lw += __shfl_xor_sync(0xffffffffu, lw, o);
      l += lw;
    }
    if (lane == 0) {
      blk_ml[r][0] = mx, blk_ml[r][1] = l;
      if (stats_m != nullptr) stats_m[row0 + r] = mx, stats_l[row0 + r] = l;
    }
  }
  __syncthreads();
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) acc[qi] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < n_live; j0 += kJ) {
    if (j0 > 0) load_round(j0);
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      const int r = min((int)(threadIdx.x + qi * kThreads) / Q4, RB - 1);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (j0 + j < n_live)
          acc[qi] = fma4(x[qi][j], part.wts[r][j0 + j], acc[qi]);
    }
  }
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
    const int i = threadIdx.x + qi * kThreads;
    if (i >= sp.nh * Q4) break;
    const int r = i / Q4, d = 4 * (i % Q4);
    store4(out + sp.b * o_sb + (int64_t)(sp.h0 + r) * o_sh + d,
           scale4(acc[qi], 1.f / fmaxf(blk_ml[r][1], 1e-30f)));
  }
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float *part_acc, *part_ml, *stats_m, *stats_l;
  int* counters;
  int B, S, Hkv, rep, n_split, chunk;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
  int window;
};

template <typename T, int D, int RB, bool kMma>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_groups = (a.rep + RB - 1) / RB;
  const dim3 grid(a.B * a.Hkv * n_groups, a.n_split);
  flash_decode_kernel<T, D, RB, kMma><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.out),
      a.part_acc, a.part_ml, a.stats_m, a.stats_l, a.counters, a.S, a.Hkv,
      a.rep, n_groups, a.n_split, a.chunk, a.q_sb, a.q_sh, a.k_sb, a.k_ss,
      a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_sh, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rep(int path, const Args& a, cudaStream_t stream) {
  if (path == 1) {  // the tensor-core path: head dims 64 and 128
    if constexpr (D >= 64) return launch<T, D, kMmaHeads, true>(a, stream);
    return cudaErrorInvalidValue;
  }
  if (a.rep == 1) return launch<T, D, 1, false>(a, stream);
  if (a.rep == 2) return launch<T, D, 2, false>(a, stream);
  if (a.rep <= 4) return launch<T, D, 4, false>(a, stream);
  return launch<T, D, 8, false>(a, stream);
}

template <typename T>
cudaError_t dispatch_d(int D, int path, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16:
      return dispatch_rep<T, 16>(path, a, stream);
    case 32:
      return dispatch_rep<T, 32>(path, a, stream);
    case 64:
      return dispatch_rep<T, 64>(path, a, stream);
    case 128:
      return dispatch_rep<T, 128>(path, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// n_split and chunk come from the wrapper's plan (n_split * chunk >= S);
// with n_split > 1, part_acc holds B*H*n_split*D floats, part_ml
// B*H*n_split*2, and `counters` B*Hkv*head-groups ints, zero on entry and
// left zero (head groups: ceil(H / Hkv / 16) on the tensor-core path, else
// ceil(H / Hkv / 8) for H / Hkv > 2, else 1).  path: 0 = CUDA cores, 1 =
// tensor cores.  `window` > 0 masks the slots below lengths[b] - window
// (0: no window).  `stats_m` and `stats_l` (B * H float32 each, both or
// neither) receive each row's softmax max and normaliser; null: not
// written.  Head dims 16, 32, 64 and 128 are compiled.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_acc, void* part_ml, void* stats_m, void* stats_l,
    void* counters, int B, int S, int H, int Hkv, int D, int n_split,
    int chunk, int path, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_sh, float scale, int window, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || n_split <= 0 ||
      n_split > kMaxSplits || chunk <= 0 || (int64_t)n_split * chunk < S ||
      window < 0 ||
      (path != 0 && path != 1) ||
      (n_split > 1 &&
       (part_acc == nullptr || part_ml == nullptr || counters == nullptr)) ||
      ((stats_m == nullptr) != (stats_l == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(lengths), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               static_cast<float*>(stats_m), static_cast<float*>(stats_l),
               static_cast<int*>(counters), B, S, Hkv, H / Hkv, n_split,
               chunk, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
               o_sh, scale, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(D, path, a, st);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(D, path, a, st);
  return (int)cudaErrorInvalidValue;
}
