// flash_decode for Hopper (sm_90a): one query token per sequence against a
// KV cache, over each sequence's valid prefix (slot < lengths[b]).
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
// Layout: q (B, H, D), caches (B, S, Hkv, D), all addressed through element
// strides with the last dimension contiguous.  The Marian decoder keeps its
// caches as (B, T, H*D) with the heads folded in; the wrapper hands that
// buffer over as a strided (B, T, H, D) view, so nothing is transposed or
// copied per step (the JAX wrapper transposes and copies both caches on
// every call).  GQA: the rep = H / Hkv query heads of one kv head share
// every staged K/V tile.
//
// What bounds it on this card: HBM bytes.  Per call it must read the valid
// prefix of K and V once (2 * B * len * Hkv * D elements) and q, and write
// the output; the two dot products are ~2 FLOP per byte read, far below the
// H100's ~20 FLOP/byte float32 balance point.  Its time at the Marian
// shapes is launch latency plus that stream.
//
// What this simple design leaves on the table:
//   * One block per (b, kv head), looping over the cache.  At B=1 and 8
//     heads that is 8 blocks on 132 SMs, so a long cache streams through
//     8 SMs' load units.  The first fix is to split S across blocks as well
//     (split-K flash decode) and add a small reduce pass over the partial
//     (max, sum, acc) triples.
//   * Scalar loads staged through shared memory with no cp.async/TMA
//     double buffering, so a tile's load does not overlap the previous
//     tile's math.
//   * With rep = 1 (Marian is plain MHA) only D of the 128 threads do the
//     P.V accumulate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // cache slots staged per iteration
constexpr float kMasked = -1e30f;  // score of a masked slot (NEG_INF there)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int rep, int d) {
  // q, acc: rep x d; k tile: kTile x (d + 1); v tile: kTile x d;
  // scores/weights: rep x kTile; running max, sum and rescale: 3 x rep
  return sizeof(float) * (size_t)(2 * rep * d + kTile * (d + 1) + kTile * d +
                                  rep * kTile + 3 * rep);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int S, int Hkv, int rep, int D, int64_t q_sb,
                        int64_t q_sh, int64_t k_sb, int64_t k_ss,
                        int64_t k_sh, int64_t v_sb, int64_t v_ss,
                        int64_t v_sh, int64_t o_sb, int64_t o_sh,
                        float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int g = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Dp = D + 1;  // padded K row: column reads hit distinct banks
  float* q_s = smem;                 // rep x D
  float* acc_s = q_s + rep * D;      // rep x D
  float* k_s = acc_s + rep * D;      // kTile x Dp
  float* v_s = k_s + kTile * Dp;     // kTile x D
  float* p_s = v_s + kTile * D;      // rep x kTile: scores, then weights
  float* m_s = p_s + rep * kTile;    // rep: running max
  float* l_s = m_s + rep;            // rep: running sum
  float* a_s = l_s + rep;            // rep: this tile's rescale factor

  const int len = lengths[b];
  // With len >= 1 the slots at or past len carry zero weight and are not
  // visited; with len <= 0 every slot is masked and all S are visited.
  const int n_slots = len > 0 ? min(len, S) : S;

  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[i] = to_f32(q[b * q_sb + (int64_t)(g * rep + r) * q_sh + d]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.f;
  }
  const T* kb = k + b * k_sb + g * k_sh;
  const T* vb = v + b * v_sb + g * v_sh;

  for (int t0 = 0; t0 < n_slots; t0 += kTile) {
    const int nt = min(kTile, n_slots - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < nt * D; i += kThreads) {
      const int j = i / D, d = i % D;
      k_s[j * Dp + d] = to_f32(kb[(int64_t)(t0 + j) * k_ss + d]);
      v_s[j * D + d] = to_f32(vb[(int64_t)(t0 + j) * v_ss + d]);
    }
    __syncthreads();
    for (int i = tid; i < rep * kTile; i += kThreads) {
      const int r = i / kTile, j = i % kTile;
      float s = -INFINITY;  // past the visited slots: no weight at all
      if (j < nt) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + j * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = (t0 + j < len) ? dot * scale : kMasked;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int r = warp; r < rep; r += kThreads / 32) {
      float* pr = p_s + r * kTile;
      float mx = -INFINITY;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, pr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < rep * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr = p_s + r * kTile;
      float a = acc_s[i] * a_s[r];
      for (int j = 0; j < nt; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    out[b * o_sb + (int64_t)(g * rep + r) * o_sh + d] =
        from_f32<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int S, int Hkv,
                   int rep, int D, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                   int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                   int64_t v_sh, int64_t o_sb, int64_t o_sh, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(rep, D);
  // raised once to the largest size asked for, outside any graph capture
  // that replays the launch
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  flash_decode_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, Hkv, rep,
      D, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int B, int S,
                                  int H, int Hkv, int D, int64_t q_sb,
                                  int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                  int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                  int64_t v_sh, int64_t o_sb, int64_t o_sh,
                                  float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, k, v, lens, out, B, S, Hkv, rep, D, q_sb, q_sh, k_sb,
                      k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, scale, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, k, v, lens, out, B, S, Hkv, rep, D, q_sb,
                              q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
                              o_sh, scale, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
