// flash_attention forward for Hopper (sm_90a): blocked attention with an
// online softmax in float32, an optional per-sequence key-prefix `lengths`,
// an optional causal mask and sliding window, with both products on the
// tensor cores.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (function at line 97, its
// pl.pallas_call at line 131, body `_flash_kernel` at line 45).  It computes
// what that kernel computes: scores q.k * scale; a key is valid when
// k_pos < lengths[b] and, when causal, k_pos <= q_pos at offset 0 (queries
// and keys both start at position 0, as at flash_attention.py:73-76);
// invalid keys score -1e30; output acc / max(l, 1e-30) in the input's type.
// A row with no valid key averages over every key, as the TPU kernel does;
// callers clamp lengths to >= 1.  Ragged S and T need no padding: the kernel
// masks the tails itself.
//
// One bound more than the TPU kernel: a sliding `window` (0 = none, causal
// only) also masks keys at or below q_pos - window, the mask the reference
// LM's windowed attention applies (src/repro/models/layers/attention.py,
// blocked_sdpa), so the port's windowed prefill runs here too.  Key tiles
// wholly below every row's window are not visited.
//
// Layout: q (B, S, H, D), k/v (B, T, Hkv, D), out (B, S, H, D), addressed
// through element strides with the last dimension contiguous and every
// row 16-byte aligned.  GQA: a block serves one kv head; its query rows are
// the flattened (position, grouped head) pairs of that kv head, so every
// staged K/V tile is shared by the rep = H / Hkv query heads of the group.
//
// What bounds it on this card: operations.  4 * S * T * D FLOP per (b, head)
// against 2 * (S + T) * D elements moved: at the Marian encoder's S = T = 512
// that is 128 FLOP/byte in float32, and at zamba2's causal S = 2048 about
// 260; both sit above the balance point of float32-accurate tensor-core
// products (3 x TF32 at 495 TFLOP/s = 165 TFLOP/s against 3.35 TB/s is ~49
// FLOP/byte), and bf16 at whisper's S = T = 1500 (375 FLOP/byte) above
// bf16's (~295).  In practice what bounds the wgmma kernel is its softmax
// on the CUDA cores: per score an FFMA, an ex2 on the MUFU unit, a max, a
// sum and, in bf16, the hi / lo split of P; the tensor cores finish a
// tile's products well before the warpgroup finishes its exponentials.  At
// Marian's short sentences (S ~ 20-64) it is launch latency and the fill
// of 132 SMs.
//
// Two kernels compute the same function; the wrapper's plan
// (kernels/flash_attention.py, attention_plan, a pure function of the
// shape) picks one: the warp-specialised wgmma kernel at head dims 64 and
// 128 when a kv head's flattened rows fill at least 3/4 of its blocks
// (64, 128 or 192 rows) and the blocks number at least WGMMA_MIN_BLOCKS
// (128: in chip_smoke.py phase 6's sweep of both kernels it won wherever
// both held and lost at shapes that filled half or two thirds of their
// blocks), else the mma.sync kernel.
// Neither falls back to the other: a kernel that fails to build or launch
// raises.
//
// The wgmma kernel (flash_attention_ws_kernel):
//   * Warp-specialised.  Warpgroup 0 is the producer: one thread keeps a
//     ring of K/V tiles filled by TMA (cp.async.bulk.tensor through 4-D
//     tensor maps over the (B, T, Hkv, D) strides, 128-byte swizzled,
//     zero-filled past T), each slot completing on an mbarrier; the
//     consumers hand a slot back through a second mbarrier.  The tensor
//     maps are __grid_constant__ parameters, so a captured CUDA graph keeps
//     them; they are encoded per call through cuTensorMapEncodeTiled, taken
//     from the driver by cudaGetDriverEntryPointByVersion (no -lcuda).  The
//     producer gives its registers to the consumers (setmaxnreg).
//   * Each consumer warpgroup owns 64 flattened (position, grouped head)
//     rows; its Q rows sit in shared memory, 128-byte swizzled.  S = Q K^T
//     runs on wgmma with Q and K from shared memory (K-major B128
//     descriptors).  The softmax runs in registers on wgmma's accumulator,
//     which is per warp the mma.sync C layout (quad shuffles for the row
//     max and sum).  P.V runs on wgmma with P from registers: per warp the
//     accumulator of S is the A fragment of P.V (bf16 as is; TF32 after the
//     relabelling of the mma.sync kernel below).
//   * bf16: V is the MN-major (transposed) B operand, read as TMA wrote it.
//     P keeps ~16 bits as P_hi.V + P_lo.V (the reference's P is float32).
//   * float32: 3 x TF32 as in the mma.sync kernel.  TF32 wgmma takes
//     K-major operands only, so P.V needs V transposed (keys contiguous).
//     Once per block and tile, the consumers split K into TF32 hi / lo and
//     V into V^T hi / lo, in shared memory shared by both warpgroups, V^T's
//     keys of each 8 in the order the S accumulator hands P over; each
//     tile's P.V sums in fresh accumulators added to O in float32.
//   * Each product is waited for before the next step.  Issuing tile n's
//     S together with tile n - 1's P.V (so the softmax overlaps P.V), and
//     ping-pong turns between two warpgroups, were both slower on the
//     card at whisper's, zamba2's and qwen3-8b's long bf16 prefills.
//   * Masks are applied per element only in tiles that straddle a
//     boundary, as a branch around the whole tile (predicated per element,
//     the mask cost as much as the rest of the softmax); elsewhere the scale
//     is folded into the exponent (one FFMA a score).
//   * Tiles and stages, (dtype, D) -> consumer warpgroups (rows), keys per
//     tile, ring stages, shared memory:
//       bf16    64  -> 3 (192), 64 keys, 3 stages,  73 KB
//       bf16   128  -> 3 (192), 64 keys, 3 stages, 145 KB
//       float32 64  -> 2 (128), 64 keys, 2 stages, 193 KB (+ the split tiles)
//       float32 128 -> 1 (64),  32 keys, 2 stages, 193 KB (a 128-key
//                      float32 tile of K or V is 64 KB before its split)
//     bf16 runs three consumer warpgroups: softmax-bound, it gains from
//     the third's warps (with 64-key tiles to fit 160 registers a thread)
//     more than it loses on short shapes, which the plan gives the
//     mma.sync kernel.
//
// The mma.sync kernel (flash_attention_kernel, every head dim;
// FlashAttention-2 style):
//   * Each warp owns 16 query rows.  Scores S = Q K^T stay in the mma
//     accumulator registers; the row max and sum use quad shuffles; the
//     running (m, l) and the output accumulator stay in registers.
//   * bfloat16: m16n8k16.bf16 with float32 accumulation (a bf16 x bf16
//     product is exact, so Q.K^T is float32-exact).  The score accumulator
//     of two 8-key n-tiles is exactly the A fragment of the 16-key P.V
//     step, so P is packed in registers, as hi + lo bf16 pairs (two mmas)
//     to keep the float32 weights to ~16 bits; V's B fragments come from
//     shared memory through ldmatrix.trans.
//   * float32: 3 x TF32 on m16n8k8.tf32.  Each operand x is split into
//     hi = x rounded to TF32 (as cvt.rna.tf32, by an integer add and mask)
//     and lo = x - hi (truncated to TF32 by the mma itself), and lo.hi +
//     hi.lo + hi.hi is accumulated in float32: near float32 accuracy (the
//     terms dropped are ~2^-21 relative) where one TF32 product keeps three
//     decimal digits.  The TF32 C fragment holds key columns (2t, 2t+1)
//     where the A fragment wants (t, t+4); instead of shuffling P, the P.V
//     step reads its k index t as key 2t and t+4 as key 2t+1 and loads V's
//     rows in the same order, which sums the same products.  The same
//     relabelling of the head dim lets Q and K fragments load as float2.
//     A tile's P.V products sum in fresh accumulators that are added to O
//     in float32: the tensor core's own addition into a running O would
//     lose accuracy with every tile (an error growing with the keys).
//   * K/V tiles are double-buffered in shared memory and filled with 16-byte
//     cp.async.cg (zero-filled past T) while the previous tile computes.
//     Rows are padded (K: D + 8, V: D + 4 floats; bf16: D + 8) so fragment
//     loads and ldmatrix hit distinct banks.  bf16 tiles stay bf16.
//   * 16, 32 or 64 query rows per block (pick_block_q: short sentences
//     still give >= 132 blocks).  A block is always 4 warps: with fewer
//     than 64 rows, 2 or 4 warps share 16 rows and split each key tile
//     between them, each with its own online softmax, and merge their (m,
//     l, O) once at the end, in a fixed order, through shared memory.
//
// Both skip key tiles past lengths[b], (causal) past the block's last
// query position and wholly below its first position's window; a warp or
// warpgroup also skips the tiles that lie there for all its own rows.
// Every instantiation's dynamic shared memory limit is raised on the
// first call of the C entry point, whatever the shape, so a CUDA graph
// capture never meets an instantiation that was not set up.
//
// What it still leaves for later: the softmax bound of the wgmma kernel
// (overlapping a warpgroup's softmax with products lost on the card as
// tried: see above; a cheaper hi / lo split of bf16 P); float32's split
// pass and products run in turn (the split done by the producer
// warpgroup from a single raw stage was slower on the card); wgmma at
// head dims 16 and 32; splitting K across blocks for very long keys at
// small B * H.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr float kMasked = -1e30f;  // score of a masked key (NEG_INF there)
constexpr float kLog2e = 1.4426950408889634f;

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::mma_3xtf32;
using repro::smem_addr;
using repro::split_tf32;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) = hi + lo, both packed bf16 pairs: P.V as P_lo.V + P_hi.V keeps
// the weights to ~16 bits where one bf16 P would keep 8
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

// 2^x by the MUFU unit (inputs below -126 flush the result to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Tile geometry of one instantiation.
template <typename T, int D>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  // keys per tile: float32 at D = 128 halves it to bound registers and smem
  static constexpr int BK = (kF32 && D > 64) ? 32 : 64;
  static constexpr int KST = D + 8;                // K row stride (elements)
  static constexpr int VST = kF32 ? D + 4 : D + 8;  // V row stride
  static constexpr int EPC = 16 / sizeof(T);        // elements per 16 bytes
  static constexpr int CPR = D / EPC;               // 16-byte chunks per row
  static constexpr int DT = D / 8;                  // 8-column n-tiles of O
  static constexpr size_t kStage = (size_t)BK * (KST + VST) * sizeof(T);
  static constexpr size_t kSmem = 2 * kStage;
};

constexpr int kWarps = 4;  // every block: 4 warps
constexpr int kThreads = 32 * kWarps;

// A block of BQ query rows has BQ / 16 row groups of 16; its 4 warps are
// those row groups times KW = 64 / BQ key groups.  A key group takes its
// share of every key tile with its own online softmax, and the key groups
// of a row group merge once, at the end, in a fixed order.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ lengths,
                           T* __restrict__ out, int S, int T_len, int Hkv,
                           int rep, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh,
                           float scale, int causal, int window) {
  using G = Tile<T, D>;
  constexpr int BK = G::BK, KST = G::KST, VST = G::VST, DT = G::DT;
  constexpr int KW = kWarps * 16 / BQ;  // key groups per row group
  constexpr int BKW = BK / KW;          // keys of a tile per key group
  constexpr int NT = BKW / 8;           // this warp's 8-key n-tiles
  static_assert(BKW % (G::kF32 ? 8 : 16) == 0, "key group too narrow");
  static_assert(sizeof(float) * kWarps * 16 * (D + 2) <= G::kSmem,
                "the key groups' merge must fit the stage buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage[2][2];  // [buffer][0 = K, 1 = V]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    stage[i][0] = reinterpret_cast<T*>(smem_raw + i * G::kStage);
    stage[i][1] = stage[i][0] + BK * KST;
  }

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = warp / KW, kg = warp % KW;  // row group, key group
  const int gq = lane >> 2, tq = lane & 3;   // mma group / thread in group
  const int b = blockIdx.y / Hkv;
  const int g = blockIdx.y % Hkv;
  const int rows = S * rep;                  // flattened (position, head)
  const int row0 = blockIdx.x * BQ;
  const int wrow0 = row0 + rg * 16;          // this warp's first row
  const int len = lengths != nullptr ? lengths[b] : T_len;
  const float scale2 = scale * kLog2e;       // softmax in base 2

  // this thread's two rows (g and g + 8 of the warp's 16)
  int qpos[2];
  const T* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = min(wrow0 + gq + 8 * i, rows - 1);
    const int s = f / rep, h = g * rep + f % rep;
    qpos[i] = s;
    qrow[i] = q + b * q_sb + (int64_t)s * q_ss + (int64_t)h * q_sh;
  }
  const bool row_ok[2] = {wrow0 + gq < rows, wrow0 + gq + 8 < rows};

  // Q fragments in registers for the whole key loop (raw values; float32
  // splits them per tile).  f32: chunk kc covers head dims kc*8..kc*8+7,
  // A column t <-> dim 2t and t+4 <-> 2t+1.  bf16: chunk kc covers 16.
  constexpr int KC = G::kF32 ? D / 8 : D / 16;
  float qf[G::kF32 ? KC : 1][4];
  uint32_t qb[G::kF32 ? 1 : KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    if constexpr (G::kF32) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float2 x = make_float2(0.f, 0.f);
        if (row_ok[i])
          x = *reinterpret_cast<const float2*>(
              reinterpret_cast<const float*>(qrow[i]) + kc * 8 + 2 * tq);
        qf[kc][i] = x.x;      // a0 (row g) / a1 (row g + 8): dim 2t
        qf[kc][2 + i] = x.y;  // a2 / a3: dim 2t + 1
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t lo = 0, hi = 0;
        if (row_ok[i]) {
          const uint32_t* p = reinterpret_cast<const uint32_t*>(
              qrow[i] + kc * 16 + 2 * tq);
          lo = p[0];
          hi = p[4];
        }
        qb[kc][i] = lo;      // a0 / a1: dims 2t, 2t+1
        qb[kc][2 + i] = hi;  // a2 / a3: dims 2t+8, 2t+9
      }
    }
  }

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;

  // Keys [kv_begin, kv_end) are visited.  When every row of the block has a
  // valid key, keys past the prefix (and, causal, past the block's last
  // position, or below its first position's window) get weight exactly 0
  // and are skipped.  A row with no valid key (len <= 0, or a window wholly
  // past the prefix) averages over every key, so then all T are visited.
  const int win = causal ? window : 0;   // the window bounds causal rows only
  const int kv_valid = len > 0 ? min(len, T_len) : 0;
  const int block_first_pos = row0 / rep;
  const int block_last_pos = (min(row0 + BQ, rows) - 1) / rep;
  // the last row's window starts past every valid key: some row is empty
  const bool all_rows_live =
      len > 0 && (win <= 0 || block_last_pos - win + 1 < kv_valid);
  int kv_begin = 0, kv_end = T_len;
  if (all_rows_live) {
    kv_end = causal ? min(kv_valid, block_last_pos + 1) : kv_valid;
    if (win > 0) kv_begin = max(0, block_first_pos - win + 1);
  }
  const bool warp_live = wrow0 < rows;
  const int warp_first_pos = min(wrow0, rows - 1) / rep;
  const int warp_last_pos = (min(wrow0 + 16, rows) - 1) / rep;

  const T* kb = k + b * k_sb + (int64_t)g * k_sh;
  const T* vb = v + b * v_sb + (int64_t)g * v_sh;
  auto load_tile = [&](int buf, int t0) {
    T* ks = stage[buf][0];
    T* vs = stage[buf][1];
    for (int i = tid; i < BK * G::CPR; i += kThreads) {
      const int r = i / G::CPR, c = (i % G::CPR) * G::EPC;
      const int key = t0 + r;
      const bool ok = key < T_len;
      const int64_t kr = ok ? (int64_t)key : 0;
      cp_async16(ks + r * KST + c, kb + kr * k_ss + c, ok ? 16 : 0);
      cp_async16(vs + r * VST + c, vb + kr * v_ss + c, ok ? 16 : 0);
    }
  };

  const int it0 = kv_begin / BK;
  const int n_tiles = (kv_end + BK - 1) / BK;
  if (it0 < n_tiles) load_tile(it0 & 1, it0 * BK);
  cp_async_commit();
  for (int it = it0; it < n_tiles; ++it) {
    const int t0 = it * BK;
    if (it + 1 < n_tiles) {
      load_tile((it + 1) & 1, t0 + BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` visible to every warp

    // this warp's keys of the tile: [k0, k0 + BKW).  When every row has a
    // valid key, keys past the prefix, (causal) past every row of the warp
    // or below every row's window get weight exactly 0, so a warp whose
    // keys all lie there skips the tile
    const int k0 = t0 + kg * BKW;
    const bool skip =
        !warp_live ||
        (all_rows_live &&
         (k0 >= kv_valid || (causal && k0 > warp_last_pos) ||
          (win > 0 && k0 + BKW - 1 <= warp_first_pos - win)));
    if (!skip) {
      const T* ks = stage[it & 1][0] + kg * BKW * KST;
      const T* vs = stage[it & 1][1] + kg * BKW * VST;
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;

      // S = Q K^T
      if constexpr (G::kF32) {
        const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(qf[kc][e], ah[e], al[e]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float2 x = *reinterpret_cast<const float2*>(
                kf + (n * 8 + gq) * KST + kc * 8 + 2 * tq);
            uint32_t bh[2], bl[2];
            split_tf32(x.x, bh[0], bl[0]);
            split_tf32(x.y, bh[1], bl[1]);
            mma_3xtf32(sc[n], ah, al, bh, bl);
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint32_t* p = reinterpret_cast<const uint32_t*>(
                ks + (n * 8 + gq) * KST + kc * 16 + 2 * tq);
            const uint32_t bk[2] = {p[0], p[4]};
            mma_bf16(sc[n], qb[kc], bk);
          }
        }
      }

      // scale to base 2, mask where the keys straddle a boundary
      const bool edge = !all_rows_live || k0 + BKW > kv_valid ||
                        (causal && k0 + BKW - 1 > warp_first_pos) ||
                        (win > 0 && k0 <= warp_last_pos - win);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[n][e] * scale2;
          if (edge) {
            const int key = k0 + n * 8 + 2 * tq + (e & 1);
            if (key >= T_len)
              s = -INFINITY;  // past the keys: no weight at all
            else if (key >= len || (causal && key > qpos[e >> 1]) ||
                     (win > 0 && key <= qpos[e >> 1] - win))
              s = kMasked;
          }
          sc[n][e] = s;
        }
      // online softmax: row g uses e = 0, 1; row g + 8 uses e = 2, 3
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
        const float m_new = fmaxf(m[i], quad_max(mx));
        const float alpha = exp2f(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = exp2f(sc[n][e] - m_new);
            sc[n][e] = p;
            sum += p;
          }
        l[i] = alpha * l[i] + sum;  // this thread's columns; quad sum at end
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          o[c][2 * i] *= alpha;
          o[c][2 * i + 1] *= alpha;
        }
      }

      // O += P V
      if constexpr (G::kF32) {
        // The tile's product is summed in fresh accumulators and added to
        // O with one float32 add per element.  Fed the running O as its C
        // operand, the tensor core would round 3 * NT products into a sum
        // that grows with every tile: an error that grows with the keys
        // (1e-4 at 4200 keys of a qk-normed model, where a float32 einsum
        // keeps 6e-6).
        const float* vf = reinterpret_cast<const float*>(vs);
        float acc[DT][4];
#pragma unroll
        for (int c = 0; c < DT; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // A column t <-> key 8j + 2t, t + 4 <-> key 8j + 2t + 1
          const float pa[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(pa[e], ah[e], al[e]);
          const float* v0 = vf + (j * 8 + 2 * tq) * VST + gq;
#pragma unroll
          for (int c = 0; c < DT; ++c) {
            uint32_t bh[2], bl[2];
            split_tf32(v0[c * 8], bh[0], bl[0]);
            split_tf32(v0[VST + c * 8], bh[1], bl[1]);
            mma_3xtf32(acc[c], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int c = 0; c < DT; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[c][e] += acc[c][e];
      } else {
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t ph[4], pl[4];
          split_bf16(sc[2 * j][0], sc[2 * j][1], ph[0], pl[0]);
          split_bf16(sc[2 * j][2], sc[2 * j][3], ph[1], pl[1]);
          split_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], ph[2], pl[2]);
          split_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int c = 0; c < DT; c += 2) {
            uint32_t bv[4];
            ldmatrix_x4_trans(
                bv, vs + (j * 16 + (lane & 15)) * VST + (c + (lane >> 4)) * 8);
            mma_bf16(o[c], pl, bv);
            mma_bf16(o[c], ph, bv);
            mma_bf16(o[c + 1], pl, bv + 2);
            mma_bf16(o[c + 1], ph, bv + 2);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buffer it & 1
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  if constexpr (KW > 1) {
    // key groups 1.. hand (m, l, O) to key group 0 through the (now idle)
    // stage buffers; it merges them in key-group order
    float* red_o = reinterpret_cast<float*>(smem_raw);  // [warp][16][D]
    float* red_ml = red_o + kWarps * 16 * D;            // [warp][16][2]
    if (kg > 0) {
      float* wo = red_o + warp * 16 * D;
      float* wml = red_ml + warp * 32;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = gq + 8 * i;
#pragma unroll
        for (int c = 0; c < DT; ++c)
          *reinterpret_cast<float2*>(wo + r * D + c * 8 + 2 * tq) =
              make_float2(o[c][2 * i], o[c][2 * i + 1]);
        if (tq == 0) wml[2 * r] = m[i], wml[2 * r + 1] = l[i];
      }
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int w = warp + 1; w < warp + KW; ++w) {
      const float* wo = red_o + w * 16 * D;
      const float* wml = red_ml + w * 32;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = gq + 8 * i;
        const float m2 = wml[2 * r], l2 = wml[2 * r + 1];
        const float mx = fmaxf(m[i], m2);
        const float s1 = exp2f(m[i] - mx), s2 = exp2f(m2 - mx);
        l[i] = l[i] * s1 + l2 * s2;
        m[i] = mx;
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          const float2 x =
              *reinterpret_cast<const float2*>(wo + r * D + c * 8 + 2 * tq);
          o[c][2 * i] = o[c][2 * i] * s1 + x.x * s2;
          o[c][2 * i + 1] = o[c][2 * i + 1] * s1 + x.y * s2;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const int f = wrow0 + gq + 8 * i;
    const int s = f / rep, h = g * rep + f % rep;
    T* orow = out + b * o_sb + (int64_t)s * o_ss + (int64_t)h * o_sh;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const float x0 = o[c][2 * i] * inv, x1 = o[c][2 * i + 1] * inv;
      if constexpr (G::kF32)
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(orow) + c * 8 +
                                   2 * tq) = make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(orow + c * 8 + 2 * tq) =
            pack_bf16(x0, x1);
    }
  }
}

// ------------------------------------------------ warp-specialised kernel --
// Tile geometry of the wgmma kernel for (T, D): consumer warpgroups (64
// query rows each), keys per tile and the ring of STAGES K/V slots TMA
// fills, sized to the 227 KB of shared memory a block may have.  Byte
// offsets from the 1024-aligned base: Q (bf16: one copy; float32: TF32 hi
// and lo), the ring, float32's work tiles (K hi, K lo, V^T hi, V^T lo),
// the mbarriers.
template <typename T, int D>
struct Ws {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int WG = kF32 ? (D == 128 ? 1 : 2) : 3;
  static constexpr int BQ = 64 * WG;
  static constexpr int BK = kF32 && D == 128 ? 32 : 64;
  static constexpr int STAGES = kF32 ? 2 : 3;
  static constexpr int ROWB = D * (int)sizeof(T);  // bytes of one row
  static constexpr int EPB = 128 / (int)sizeof(T); // elements per 128 bytes
  static constexpr int TILE = BK * ROWB;           // one K or V tile
  static constexpr int QTILE = BQ * ROWB;
  static constexpr int SLOT = 2 * TILE;            // a ring slot: [K][V]
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + (kF32 ? 2 : 1) * QTILE;
  static constexpr int kWork = kRing + STAGES * SLOT;
  static constexpr int kBar = kWork + (kF32 ? 4 * TILE : 0);
  static constexpr int kSmem = kBar + 2 * STAGES * 8 + 1024;  // + alignment
  static constexpr int kThreads = 128 * (WG + 1);
  // registers a consumer thread takes from the producer warpgroup's 104
  // (setmaxnreg): the block's 65536 shared by 128 x 24 and WG x 128 x this
  static constexpr int kConsumerRegs = WG > 2 ? 160 : 240;
  static_assert(ROWB % 128 == 0 && TILE % 1024 == 0, "128-byte blocks");
  static_assert(kSmem <= 232448, "over the 227 KB of a block");
};

template <typename T, int D>
__global__ void __launch_bounds__(Ws<T, D>::kThreads, 1)
    flash_attention_ws_kernel(const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              int kv_order, const T* __restrict__ q,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, int S, int T_len, int Hkv,
                              int rep, int64_t q_sb, int64_t q_ss,
                              int64_t q_sh, int64_t o_sb, int64_t o_ss,
                              int64_t o_sh, float scale, int causal,
                              int window) {
  using C = Ws<T, D>;
  namespace hw = repro::sm90;
  constexpr int BK = C::BK, BQ = C::BQ, WG = C::WG, STAGES = C::STAGES;
  constexpr int TILE = C::TILE, QTILE = C::QTILE;
  constexpr int KSTEPS = C::ROWB / 32;  // 32-byte product steps over D
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kBar);
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.y / Hkv;
  const int g = blockIdx.y % Hkv;
  const int rows = S * rep;
  const int row0 = blockIdx.x * BQ;
  const int len = lengths != nullptr ? lengths[b] : T_len;
  // the block's key range, as in the mma.sync kernel
  const int win = causal ? window : 0;
  const int kv_valid = len > 0 ? min(len, T_len) : 0;
  const int block_first_pos = row0 / rep;
  const int block_last_pos = (min(row0 + BQ, rows) - 1) / rep;
  const bool all_rows_live =
      len > 0 && (win <= 0 || block_last_pos - win + 1 < kv_valid);
  int kv_begin = 0, kv_end = T_len;
  if (all_rows_live) {
    kv_end = causal ? min(kv_valid, block_last_pos + 1) : kv_valid;
    if (win > 0) kv_begin = max(0, block_first_pos - win + 1);
  }
  const int it0 = kv_begin / BK;
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 4 * WG);  // one arrival per consumer warp
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the K/V ring filled ----
    if constexpr (WG > 1) hw::setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    hw::tma_prefetch_map(&kmap);
    hw::tma_prefetch_map(&vmap);
    for (int it = it0, n = 0; it < n_tiles; ++it, ++n) {
      const int st = n % STAGES;
      hw::mbar_wait(&empty[st], ((n / STAGES) & 1) ^ 1);
      hw::mbar_expect_tx(&full[st], 2 * TILE);
      unsigned char* kd = base + C::kRing + st * C::SLOT;
      // coordinates innermost first: (d, t, head, b) or (d, head, t, b)
      const int c1 = kv_order ? g : it * BK, c2 = kv_order ? it * BK : g;
#pragma unroll
      for (int cb = 0; cb < C::ROWB / 128; ++cb) {
        hw::tma_load_4d(kd + cb * BK * 128, &kmap, &full[st], cb * C::EPB, c1,
                        c2, b);
        hw::tma_load_4d(kd + TILE + cb * BK * 128, &vmap, &full[st],
                        cb * C::EPB, c1, c2, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  if constexpr (WG > 1) hw::setmaxnreg_inc<C::kConsumerRegs>();
  const int ct = threadIdx.x - 128;  // consumer thread
  const int wi = ct / 128;           // consumer warpgroup
  const int tw = ct % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wrow0 = row0 + 64 * wi;  // this warpgroup's first row
  const float scale2 = scale * kLog2e;

  // Q rows of this warpgroup into shared memory, 128-byte swizzled
  // (float32: split into TF32 hi and lo once, here)
  for (int idx = tw; idx < 64 * (C::ROWB / 16); idx += 128) {
    const int r = idx / (C::ROWB / 16), c16 = idx % (C::ROWB / 16);
    const int f = wrow0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (f < rows) {
      const int s = f / rep, h = g * rep + f % rep;
      x = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const unsigned char*>(
              q + b * q_sb + (int64_t)s * q_ss + (int64_t)h * q_sh) +
          c16 * 16);
    }
    const uint32_t off =
        (c16 / 8) * BQ * 128 + hw::swz128(64 * wi + r, c16 % 8);
    if constexpr (C::kF32) {
      uint4 hi, lo;
      split_tf32(__uint_as_float(x.x), hi.x, lo.x);
      split_tf32(__uint_as_float(x.y), hi.y, lo.y);
      split_tf32(__uint_as_float(x.z), hi.z, lo.z);
      split_tf32(__uint_as_float(x.w), hi.w, lo.w);
      *reinterpret_cast<uint4*>(base + C::kQ + off) = hi;
      *reinterpret_cast<uint4*>(base + C::kQ + QTILE + off) = lo;
    } else {
      *reinterpret_cast<uint4*>(base + C::kQ + off) = x;
    }
  }
  hw::fence_async_smem();
  hw::named_sync(2 + wi, 128);  // the warpgroup's Q rows, before any wgmma

  // this thread's two rows (g and g + 8 of its warp's 16)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = min(wrow0 + 16 * warp + gq + 8 * i, rows - 1) / rep;
  const bool wg_live = wrow0 < rows;
  const int wg_first_pos = min(wrow0, rows - 1) / rep;
  const int wg_last_pos = (min(wrow0 + 64, rows) - 1) / rep;

  const uint32_t q_hi = hw::smem_u32(base + C::kQ) + 64 * wi * 128;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  // when every row has a valid key, keys past the prefix, (causal) past
  // every row of the warpgroup, or below every row's window get weight
  // exactly 0: a warpgroup whose keys of a tile all lie there skips it
  auto skips = [&](int t0) {
    return !wg_live ||
           (all_rows_live &&
            (t0 >= kv_valid || (causal && t0 > wg_last_pos) ||
             (win > 0 && t0 + BK - 1 <= wg_first_pos - win)));
  };
  // S = Q K^T of the tile at `kop` on wgmma, Q and K from shared memory;
  // issued and committed, not waited for
  auto issue_s = [&](float* sc, const unsigned char* kop) {
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint32_t qa = q_hi + (kk / 4) * BQ * 128 + off;
      const uint32_t ka = hw::smem_u32(kop) + (kk / 4) * BK * 128 + off;
      if constexpr (C::kF32) {
        // lo.hi + hi.lo + hi.hi, small terms first
        hw::Wgmma<BK, false>::ss(sc, hw::desc_kmajor(qa + QTILE),
                                 hw::desc_kmajor(ka), kk > 0);
        hw::Wgmma<BK, false>::ss(sc, hw::desc_kmajor(qa),
                                 hw::desc_kmajor(ka + TILE), 1);
        hw::Wgmma<BK, false>::ss(sc, hw::desc_kmajor(qa),
                                 hw::desc_kmajor(ka), 1);
      } else {
        hw::Wgmma<BK, true>::ss(sc, hw::desc_kmajor(qa), hw::desc_kmajor(ka),
                                kk > 0);
      }
    }
    hw::wgmma_commit();
  };
  // The online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3) over a
  // tile's scores `sc` times `sf`, in base 2: weights in place, each row's
  // rescale factor of O in alpha.  The max is taken on the unscaled
  // scores and the scale folded into the exponent (one FFMA a score).
  auto row_softmax = [&](float* sc, float sf, float* alpha) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx) * sf);
      alpha[i] = fast_exp2(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = fast_exp2(fmaf(sc[4 * j + e], sf, -m_new));
          sc[4 * j + e] = p;
          sum += p;
        }
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
  };
  // The tile's scores to weights: where its keys straddle a boundary (a
  // branch around the whole tile: masking every element unconditionally
  // costs as much as the softmax), scaled first and masked (-1e30, or
  // -inf past the keys), else scaled inside the exponent.
  auto softmax = [&](float* sc, int t0, float* alpha) {
    const bool edge = !all_rows_live || t0 + BK > kv_valid ||
                      (causal && t0 + BK - 1 > wg_first_pos) ||
                      (win > 0 && t0 <= wg_last_pos - win);
    if (__builtin_expect(edge, 0)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 8 * j + 2 * tq + (e & 1);
          float& x = sc[4 * j + e];
          x *= scale2;
          if (key >= T_len)
            x = -INFINITY;  // past the keys: no weight at all
          else if (key >= len || (causal && key > qpos[e >> 1]) ||
                   (win > 0 && key <= qpos[e >> 1] - win))
            x = kMasked;
        }
      row_softmax(sc, 1.f, alpha);
    } else {
      row_softmax(sc, scale2, alpha);
    }
  };
  auto rescale = [&](const float* alpha) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
  };

  // Per tile: S = Q K^T, the softmax, P.V, each waited for in turn (two
  // consumer warpgroups interleave on their own; issuing tile n's S with
  // tile n - 1's P.V, and ping-pong turns between the warpgroups, were
  // both slower on the card).
  unsigned char* work = base + C::kWork;  // float32's split tiles
  for (int it = it0, n = 0; it < n_tiles; ++it, ++n) {
    const int st = n % STAGES;
    hw::mbar_wait(&full[st], (n / STAGES) & 1);
    const unsigned char* kraw = base + C::kRing + st * C::SLOT;
    const unsigned char* vraw = kraw + TILE;
    const int t0 = it * BK;
    const unsigned char* kop = kraw;  // the K operand of S
    if constexpr (C::kF32) {
      // every consumer is done with the previous tile's work tiles
      hw::named_sync(1, 128 * WG);
      // K: TF32 hi / lo in the stage's own layout, once for the block
      // (the loops' trip counts are constants: unrolled, their loads are
      // in flight together)
      static_assert(TILE / 16 % (128 * WG) == 0 &&
                        BK / 8 * D % (128 * WG) == 0,
                    "whole rounds of the split");
#pragma unroll
      for (int u = 0; u < TILE / 16 / (128 * WG); ++u) {
        const int i = ct + u * 128 * WG;
        const uint4 x = reinterpret_cast<const uint4*>(kraw)[i];
        uint4 hi, lo;
        split_tf32(__uint_as_float(x.x), hi.x, lo.x);
        split_tf32(__uint_as_float(x.y), hi.y, lo.y);
        split_tf32(__uint_as_float(x.z), hi.z, lo.z);
        split_tf32(__uint_as_float(x.w), hi.w, lo.w);
        reinterpret_cast<uint4*>(work)[i] = hi;
        reinterpret_cast<uint4*>(work + TILE)[i] = lo;
      }
      // V: transposed to V^T (D rows of BK keys, keys contiguous, the
      // K-major operand TF32 wgmma needs), keys of each 8 stored in the
      // order the S accumulator hands P over: keys 0, 2, 4, 6 of a group
      // at its positions 0-3, keys 1, 3, 5, 7 at 4-7.  A thread takes one
      // head dim of one 8-key group: 8 loads, 4 16-byte stores; a warp's
      // lanes take consecutive head dims (rows of V^T), so neither the
      // loads nor the swizzled stores meet a bank twice.
#pragma unroll
      for (int u = 0; u < BK / 8 * D / (128 * WG); ++u) {
        const int i = ct + u * 128 * WG;
        const int d = i % D, kg = i / D;
        float x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          x[j] = *reinterpret_cast<const float*>(
              vraw + (d / 32) * BK * 128 +
              hw::swz128(8 * kg + j, d % 32 / 4) + d % 4 * 4);
        unsigned char* row = work + 2 * TILE + (kg / 4) * D * 128;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint4 hi, lo;
          split_tf32(x[half], hi.x, lo.x);
          split_tf32(x[half + 2], hi.y, lo.y);
          split_tf32(x[half + 4], hi.z, lo.z);
          split_tf32(x[half + 6], hi.w, lo.w);
          const uint32_t at = hw::swz128(d, 2 * (kg % 4) + half);
          *reinterpret_cast<uint4*>(row + at) = hi;
          *reinterpret_cast<uint4*>(row + TILE + at) = lo;
        }
      }
      hw::fence_async_smem();
      hw::named_sync(1, 128 * WG);
      if (lane == 0) hw::mbar_arrive(&empty[st]);  // the raw stage is free
      kop = work;
    }
    if (skips(t0)) {
      if constexpr (!C::kF32)
        if (lane == 0) hw::mbar_arrive(&empty[st]);
      continue;
    }

    float sc[BK / 2], alpha[2];
    issue_s(sc, kop);
    hw::wgmma_wait<0>();
    hw::fence_regs<BK / 2>(sc);
    softmax(sc, t0, alpha);
    rescale(alpha);
    // O += P V on wgmma, P from registers
    if constexpr (C::kF32) {
      // A column q <-> key 8kk + 2q, q + 4 <-> key 8kk + 2q + 1 (V^T's key
      // order above)
      uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        split_tf32(sc[4 * kk + 0], ah[kk][0], al[kk][0]);
        split_tf32(sc[4 * kk + 2], ah[kk][1], al[kk][1]);
        split_tf32(sc[4 * kk + 1], ah[kk][2], al[kk][2]);
        split_tf32(sc[4 * kk + 3], ah[kk][3], al[kk][3]);
      }
      // the tile's product in fresh accumulators, added to O in float32
      // (the tensor core's own sum into a running O loses accuracy with
      // every tile)
      float of[D / 2];
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t va = hw::smem_u32(work + 2 * TILE) +
                            (kk / 4) * D * 128 + (kk % 4) * 32;
        hw::Wgmma<D, false>::rs(of, al[kk], hw::desc_kmajor(va), kk > 0);
        hw::Wgmma<D, false>::rs(of, ah[kk], hw::desc_kmajor(va + TILE), 1);
        hw::Wgmma<D, false>::rs(of, ah[kk], hw::desc_kmajor(va), 1);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs<D / 2>(of);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] += of[i];
    } else {
      // P as hi + lo bf16 pairs: the weights keep ~16 bits
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                     pl[kk][r]);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = hw::desc_mnmajor(
            hw::smem_u32(vraw) + kk * 16 * 128, BK * 128);
        hw::Wgmma<D, true>::rs(o, pl[kk], dv, 1);
        hw::Wgmma<D, true>::rs(o, ph[kk], dv, 1);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs<D / 2>(o);
      if (lane == 0) hw::mbar_arrive(&empty[st]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    const int f = wrow0 + 16 * warp + gq + 8 * i;
    if (f >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const int s = f / rep, h = g * rep + f % rep;
    T* orow = out + b * o_sb + (int64_t)s * o_ss + (int64_t)h * o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = o[4 * j + 2 * i] * inv, x1 = o[4 * j + 2 * i + 1] * inv;
      if constexpr (C::kF32)
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(orow) + j * 8 +
                                   2 * tq) = make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tq) =
            pack_bf16(x0, x1);
    }
  }
}

template <typename T, int D, int BQ>
cudaError_t raise_smem() {
  return cudaFuncSetAttribute(flash_attention_kernel<T, D, BQ>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Tile<T, D>::kSmem);
}

template <typename T, int D>
cudaError_t raise_smem_d() {
  cudaError_t e = raise_smem<T, D, 16>();
  if (e == cudaSuccess) e = raise_smem<T, D, 32>();
  if (e == cudaSuccess) e = raise_smem<T, D, 64>();
  return e;
}

template <typename T, int D>
cudaError_t raise_smem_ws() {
  return cudaFuncSetAttribute(flash_attention_ws_kernel<T, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Ws<T, D>::kSmem);
}

// Raise the shared-memory limit of all 28 instantiations at once.
cudaError_t raise_all() {
  const cudaError_t es[12] = {
      raise_smem_d<float, 16>(),          raise_smem_d<float, 32>(),
      raise_smem_d<float, 64>(),          raise_smem_d<float, 128>(),
      raise_smem_d<__nv_bfloat16, 16>(),  raise_smem_d<__nv_bfloat16, 32>(),
      raise_smem_d<__nv_bfloat16, 64>(),  raise_smem_d<__nv_bfloat16, 128>(),
      raise_smem_ws<float, 64>(),         raise_smem_ws<float, 128>(),
      raise_smem_ws<__nv_bfloat16, 64>(), raise_smem_ws<__nv_bfloat16, 128>()};
  for (cudaError_t e : es)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

template <typename T, int D, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int S, int T_len,
                   int Hkv, int rep, const int64_t* st, float scale,
                   int causal, int window, cudaStream_t stream) {
  const dim3 grid((S * rep + BQ - 1) / BQ, B * Hkv);
  flash_attention_kernel<T, D, BQ><<<grid, kThreads, Tile<T, D>::kSmem,
                                     stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, T_len, Hkv,
      rep, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_bq(int BQ, const void* q, const void* k, const void* v,
                        const int* lengths, void* out, int B, int S,
                        int T_len, int Hkv, int rep, const int64_t* st,
                        float scale, int causal, int window,
                        cudaStream_t stream) {
  switch (BQ) {
    case 16:
      return launch<T, D, 16>(q, k, v, lengths, out, B, S, T_len, Hkv, rep,
                              st, scale, causal, window, stream);
    case 32:
      return launch<T, D, 32>(q, k, v, lengths, out, B, S, T_len, Hkv, rep,
                              st, scale, causal, window, stream);
    case 64:
      return launch<T, D, 64>(q, k, v, lengths, out, B, S, T_len, Hkv, rep,
                              st, scale, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// A (B, T, Hkv, D) operand with element strides (sb, st, sh) as a 4-D
// tensor map whose box is 128 bytes of one row by `box_rows` keys, 128-byte
// swizzled.  Outer dimensions go in increasing stride: (d, t, head, b) when
// st <= sh (kv_order 0), else (d, head, t, b) (kv_order 1; the Marian
// decoder's folded (B, T, H*D) buffers and every contiguous tensor).
template <typename T>
cudaError_t kv_map(CUtensorMap* map, const void* ptr, int D, int T_len,
                   int Hkv, int B, int64_t sb, int64_t st, int64_t sh,
                   int box_rows, int kv_order) {
  return repro::sm90::rows_map(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      (int)sizeof(T), ptr, D, T_len, Hkv, B, sb, st, sh, 128 / (int)sizeof(T),
      box_rows, true, kv_order);
}

template <typename T, int D>
cudaError_t launch_ws(const void* q, const void* k, const void* v,
                      const int* lengths, void* out, int B, int S, int T_len,
                      int Hkv, int rep, const int64_t* st, float scale,
                      int causal, int window, cudaStream_t stream) {
  using C = Ws<T, D>;
  // both caches in one order: the smaller of the two strides inner
  const int kv_order = (st[5] < st[4] && st[8] < st[7]) ? 1 : 0;
  CUtensorMap kmap, vmap;
  cudaError_t e = kv_map<T>(&kmap, k, D, T_len, Hkv, B, st[3], st[4], st[5],
                            C::BK, kv_order);
  if (e == cudaSuccess)
    e = kv_map<T>(&vmap, v, D, T_len, Hkv, B, st[6], st[7], st[8], C::BK,
                  kv_order);
  if (e != cudaSuccess) return e;
  const dim3 grid((S * rep + C::BQ - 1) / C::BQ, B * Hkv);
  flash_attention_ws_kernel<T, D><<<grid, C::kThreads, C::kSmem, stream>>>(
      kmap, vmap, kv_order, static_cast<const T*>(q), lengths,
      static_cast<T*>(out), S, T_len, Hkv, rep, st[0], st[1], st[2], st[9],
      st[10], st[11], scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, int BQ, const void* q, const void* k,
                       const void* v, const int* lengths, void* out, int B,
                       int S, int T_len, int Hkv, int rep, const int64_t* st,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  if (BQ == 0) {  // the warp-specialised wgmma kernel
    switch (D) {
      case 64:
        return launch_ws<T, 64>(q, k, v, lengths, out, B, S, T_len, Hkv, rep,
                                st, scale, causal, window, stream);
      case 128:
        return launch_ws<T, 128>(q, k, v, lengths, out, B, S, T_len, Hkv,
                                 rep, st, scale, causal, window, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16:
      return dispatch_bq<T, 16>(BQ, q, k, v, lengths, out, B, S, T_len, Hkv,
                                rep, st, scale, causal, window, stream);
    case 32:
      return dispatch_bq<T, 32>(BQ, q, k, v, lengths, out, B, S, T_len, Hkv,
                                rep, st, scale, causal, window, stream);
    case 64:
      return dispatch_bq<T, 64>(BQ, q, k, v, lengths, out, B, S, T_len, Hkv,
                                rep, st, scale, causal, window, stream);
    case 128:
      return dispatch_bq<T, 128>(BQ, q, k, v, lengths, out, B, S, T_len, Hkv,
                                 rep, st, scale, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements, ordered q (batch, seq, head), k (...), v (...),
// out (...).  `lengths` may be null (every key valid).  `window` > 0 masks
// keys at or below q_pos - window when causal (0: no window).  block_q is
// the query rows per block of the mma.sync kernel (16, 32 or 64), or 0 for
// the warp-specialised wgmma kernel (head dims 64 and 128); the Python
// wrapper's plan chooses.
// dtype: 0 = float32, 1 = bfloat16.  Head dims 16, 32, 64 and 128 are
// compiled.
// Returns the cudaError_t of the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int S, int T_len, int H, int Hkv, int D, int block_q,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, float scale, int causal, int window,
    int dtype, void* stream) {
  // first call, whatever its shape: every instantiation's limit, outside
  // any graph capture that later replays a launch of another shape
  static const cudaError_t smem_ready = raise_all();
  if (smem_ready != cudaSuccess) return (int)smem_ready;
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(D, block_q, q, k, v, lens, out, B, S, T_len, Hkv,
                          rep, st, scale, causal, window, s);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16>(D, block_q, q, k, v, lens, out, B, S,
                                  T_len, Hkv, rep, st, scale, causal, window,
                                  s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
