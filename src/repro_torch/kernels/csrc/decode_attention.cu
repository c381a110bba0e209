// flash_decode for Hopper (sm_90a): one query token per sequence against a
// KV cache, over each sequence's valid prefix (slot < lengths[b]), with the
// cache split across blocks (split-KV) and a deterministic combine.
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
// head share every K/V row a block loads (up to 8 heads per block; more
// heads take more blocks).
//
// What bounds it on this card: HBM bytes.  Per call it must read the valid
// prefix of K and V once (2 * B * len * Hkv * D elements) and q, and write
// the output; the two dot products are ~0.5 FLOP per byte read.  At
// Marian's shapes (B = 1-8, 8 heads of 64, len <= 256) that stream is
// 0.1-4 MB, 0.03-1.3 us at 3.35 TB/s, so what is left is latency: one
// launch, one round of loads, the combine.
//
// Design:
//   * Split-KV.  Grid (B * Hkv * head groups, n_split): split i covers slots
//     [i * chunk, (i + 1) * chunk) of the capacity S.  The wrapper plans
//     (n_split, chunk) from B * Hkv and S alone (about two waves on 132
//     SMs, >= 32 slots a split), never from `lengths`, which live on the
//     device: the plan costs the host no sync and a captured CUDA graph
//     stays right when lengths change.  A split wholly past lengths[b], or
//     wholly before the window start, writes an empty partial (m = -inf,
//     l = 0) and exits.
//   * Inside a block, warps take slots.  The lanes of a row split D into
//     16-byte loads (a float32 row of 64 is 16 lanes x float4, a bf16 row 8
//     lanes), so a warp reads 32 / lanes-per-row slots at once, four such
//     steps unrolled so their loads are in flight together.  q stays in
//     registers; dots reduce by shuffles within the row's lanes; each
//     lane group keeps its own online softmax (m, l, acc) in registers.
//     Lane groups combine by shuffles and warps once, at the end, through
//     shared memory: there is no per-tile __syncthreads.
//   * Combine.  With one split the block writes the output.  Otherwise it
//     writes (m, l, acc) in float32 to scratch that the wrapper allocates
//     with the output, and a second kernel, launched by the same C entry
//     point as a programmatic dependent launch (scheduled while the split
//     grid runs, waiting on griddepcontrol.wait), combines the splits in
//     split order: no atomics, so two calls on the same inputs give
//     bitwise-equal outputs.  An empty split carries l = 0 and is left
//     out; a split of masked slots only (length <= 0) carries m = -1e30
//     and its slot count, so length <= 0 still averages over every slot.
//   * Softmax state out.  Given `stats_m` / `stats_l` (B * H float32 each),
//     the kernel also writes each (b, h) row's score maximum m and
//     normaliser l = sum exp(s - m), from the combine with splits and from
//     the block's own merge with one.  A caller that splits the cache
//     across ranks (sequence-sharded decode) merges the ranks' outputs
//     with them: weights l * exp(m - max m).  A row with no valid slot
//     carries m = -1e30, so its weight is 0 beside any live row.
//
// What it still leaves for later: fusing the combine into its consumer (the
// output projection) or into the last block of each head (a self-resetting
// counter) to save the second kernel; TMA bulk loads of whole cache tiles;
// a persistent kernel over all layers of a decode step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;         // slot steps per warp whose loads overlap
constexpr int kMaxHeads = 8;       // query heads of one kv head per block
constexpr float kMasked = -1e30f;  // score of a masked slot (NEG_INF there)

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
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
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
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

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

template <typename T, int D, int RB>
__global__ void __launch_bounds__(kThreads)
    flash_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, float* __restrict__ part_acc,
                              float* __restrict__ part_ml,
                              float* __restrict__ stats_m,
                              float* __restrict__ stats_l, int S, int Hkv,
                              int rep, int n_groups, int n_split, int chunk,
                              int64_t q_sb, int64_t q_sh, int64_t k_sb,
                              int64_t k_ss, int64_t k_sh, int64_t v_sb,
                              int64_t v_ss, int64_t v_sh, int64_t o_sb,
                              int64_t o_sh, float scale, int window) {
  constexpr int EPL = Vec<T>::N;  // elements per lane (16 bytes)
  constexpr int LPR = D / EPL;    // lanes per cache row
  constexpr int SPW = 32 / LPR;   // slots a warp reads per step
  __shared__ float red_ml[kWarps][RB][2];
  __shared__ __align__(16) float red_acc[kWarps][RB][D];

  const int hgrp = blockIdx.x % n_groups;
  const int bg = blockIdx.x / n_groups;
  const int g = bg % Hkv, b = bg / Hkv;
  const int split = blockIdx.y;
  const int H = Hkv * rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR, part = lane % LPR;

  // let the combine kernel launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int len = lengths[b];
  // Valid slots are [w_lo, min(len, S)), w_lo = len - window with a window.
  // With one valid slot or more the others carry zero weight and are not
  // visited; with none (len <= 0, or the window past the cache) every slot
  // is masked and all S are visited.
  const int w_lo = window > 0 ? max(0, len - window) : 0;
  const bool masked = len <= 0 || w_lo >= min(len, S);
  const int n_slots = masked ? S : min(len, S);
  const int lo = max(split * chunk, masked ? 0 : w_lo);
  const int hi = min(split * chunk + chunk, n_slots);
  const int h0 = g * rep + hgrp * RB;       // first query head of the block
  const int nh = min(RB, rep - hgrp * RB);  // heads this block serves

  if (lo >= hi) {  // empty split: weight 0 in the combine
    if (threadIdx.x < nh) {
      const int64_t idx = ((int64_t)b * H + h0 + threadIdx.x) * n_split + split;
      part_ml[2 * idx] = -INFINITY;
      part_ml[2 * idx + 1] = 0.f;
    }
    return;
  }

  float qv[RB][EPL], m[RB], l[RB], acc[RB][EPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < nh)
      Vec<T>::load(q + b * q_sb + (int64_t)(h0 + r) * q_sh + part * EPL,
                   qv[r]);
    else
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[r][e] = 0.f;
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const T* kb = k + b * k_sb + (int64_t)g * k_sh + part * EPL;
  const T* vb = v + b * v_sb + (int64_t)g * v_sh + part * EPL;
  for (int base = lo + warp * SPW * kUnroll; base < hi;
       base += kWarps * SPW * kUnroll) {
    float kx[kUnroll][EPL], vx[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = base + u * SPW + sub;
      ok[u] = slot < hi;
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
        s[u] = !ok[u] ? -INFINITY : (masked ? kMasked : dot * scale);
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

  // lane groups of a warp, then warps in order
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
      for (int e = 0; e < EPL; ++e) red_acc[warp][r][part * EPL + e] = acc[r][e];
      if (lane == 0) red_ml[warp][r][0] = m[r], red_ml[warp][r][1] = l[r];
    }
  }
  __syncthreads();
  if (warp != 0 || lane >= LPR) return;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= nh) break;
    float mr = red_ml[0][r][0], lr = red_ml[0][r][1], a[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) a[e] = red_acc[0][r][part * EPL + e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      merge<EPL>(mr, lr, a, red_ml[w][r][0], red_ml[w][r][1],
                 &red_acc[w][r][part * EPL]);
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(lr, 1e-30f);
#pragma unroll
      for (int e = 0; e < EPL; ++e) a[e] *= inv;
      Vec<T>::store(out + b * o_sb + (int64_t)(h0 + r) * o_sh + part * EPL, a);
      if (stats_m != nullptr && part == 0) {
        stats_m[(int64_t)b * H + h0 + r] = mr;
        stats_l[(int64_t)b * H + h0 + r] = lr;
      }
    } else {
      const int64_t idx = ((int64_t)b * H + h0 + r) * n_split + split;
      Vec<float>::store(part_acc + idx * D + part * EPL, a);
      if constexpr (EPL == 8)
        Vec<float>::store(part_acc + idx * D + part * EPL + 4, a + 4);
      if (part == 0) part_ml[2 * idx] = mr, part_ml[2 * idx + 1] = lr;
    }
  }
}

// One warp per (b, h): combine the n_split partials in split order.  Lanes
// read the splits' (m, l) together; then every lane owns head dims lane,
// lane + 32, ... and folds the splits' accumulators in split order, the
// weights passed by shuffles, so the loads do not wait on one another.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_combine_kernel(const float* __restrict__ part_acc,
                                const float* __restrict__ part_ml,
                                T* __restrict__ out, float* __restrict__ stats_m,
                                float* __restrict__ stats_l, int B, int H,
                                int D, int n_split, int64_t o_sb,
                                int64_t o_sh) {
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B * H) return;
  const float* ml = part_ml + (int64_t)row * n_split * 2;
  const float* acc = part_acc + (int64_t)row * n_split * D;
  float mx = -INFINITY;  // largest m over the live splits (l > 0)
  for (int i = lane; i < n_split; i += 32)
    if (ml[2 * i + 1] > 0.f) mx = fmaxf(mx, ml[2 * i]);
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};  // D <= 128: 4 dims a lane
  for (int i0 = 0; i0 < n_split; i0 += 32) {
    const int i = i0 + lane;
    float w = 0.f, lw = 0.f;  // an empty split (l = 0) has weight 0
    if (i < n_split && ml[2 * i + 1] > 0.f) {
      w = expf(ml[2 * i] - mx);
      lw = ml[2 * i + 1] * w;
    }
    for (int o = 16; o > 0; o >>= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
    l += lw;
    const int n = min(32, n_split - i0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          // an empty split's acc is unwritten scratch: read, never used
          const float x = acc[(int64_t)(i0 + j) * D + d];
          if (wj > 0.f) a[c] = fmaf(x, wj, a[c]);
        }
      }
    }
  }
  T* o = out + (int64_t)(row / H) * o_sb + (int64_t)(row % H) * o_sh;
  if (stats_m != nullptr && lane == 0) stats_m[row] = mx, stats_l[row] = l;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d = lane + 32 * c;
    if (d >= D) break;
    if constexpr (sizeof(T) == 4)
      o[d] = a[c] * inv;
    else
      o[d] = __float2bfloat16(a[c] * inv);
  }
}

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float *part_acc, *part_ml, *stats_m, *stats_l;
  int B, S, Hkv, rep, n_split, chunk;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
  int window;
};

template <typename T, int D, int RB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_groups = (a.rep + RB - 1) / RB;
  const dim3 grid(a.B * a.Hkv * n_groups, a.n_split);
  flash_decode_split_kernel<T, D, RB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.out),
      a.part_acc, a.part_ml, a.stats_m, a.stats_l, a.S, a.Hkv, a.rep, n_groups, a.n_split, a.chunk,
      a.q_sb, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.o_sb,
      a.o_sh, a.scale, a.window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  // programmatic dependent launch: the combine grid is scheduled while the
  // split grid runs and waits for it in griddepcontrol.wait
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  const int rows = a.B * a.Hkv * a.rep;
  cfg.gridDim = dim3((rows + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<T>,
                            (const float*)a.part_acc, (const float*)a.part_ml,
                            static_cast<T*>(a.out), a.stats_m, a.stats_l, a.B,
                            a.Hkv * a.rep, D,
                            a.n_split, a.o_sb, a.o_sh);
}

template <typename T, int D>
cudaError_t dispatch_rep(const Args& a, cudaStream_t stream) {
  if (a.rep == 1) return launch<T, D, 1>(a, stream);
  if (a.rep == 2) return launch<T, D, 2>(a, stream);
  if (a.rep <= 4) return launch<T, D, 4>(a, stream);
  return launch<T, D, kMaxHeads>(a, stream);
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16:
      return dispatch_rep<T, 16>(a, stream);
    case 32:
      return dispatch_rep<T, 32>(a, stream);
    case 64:
      return dispatch_rep<T, 64>(a, stream);
    case 128:
      return dispatch_rep<T, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// n_split and chunk come from the wrapper's plan (n_split * chunk >= S);
// with n_split > 1, part_acc holds B*H*n_split*D floats and part_ml
// B*H*n_split*2.  `window` > 0 masks the slots below lengths[b] - window
// (0: no window).  `stats_m` and `stats_l` (B * H float32 each, both or
// neither) receive each row's softmax max and normaliser; null: not
// written.  Head dims 16, 32, 64 and 128 are compiled.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the cudaError_t of the launches.
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_acc, void* part_ml, void* stats_m, void* stats_l,
    int B, int S, int H, int Hkv,
    int D, int n_split, int chunk, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_sh, float scale, int window, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || n_split <= 0 ||
      chunk <= 0 || (int64_t)n_split * chunk < S || window < 0 ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      ((stats_m == nullptr) != (stats_l == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(lengths), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               static_cast<float*>(stats_m), static_cast<float*>(stats_l),
               B, S, Hkv, H / Hkv, n_split, chunk, q_sb, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, scale, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(D, a, st);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(D, a, st);
  return (int)cudaErrorInvalidValue;
}
