// flash_attention forward for Hopper (sm_90a): blocked attention with an
// online softmax in float32, an optional per-sequence key-prefix `lengths`
// and an optional causal mask.
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
// Layout: q (B, S, H, D), k/v (B, T, Hkv, D), out (B, S, H, D), addressed
// through element strides with the last dimension contiguous.  GQA: a block
// serves one kv head; its 64 query rows are the flattened (position,
// grouped head) pairs of that kv head, so every staged K/V tile is shared
// by the rep = H / Hkv query heads of the group.
//
// Grid: (ceil(S * rep / 64), B * Hkv).  Each block stages its 64 x D query
// tile once, then loops over 64-key tiles of K and V in shared memory.
// 256 threads as a 16 x 16 grid; each thread owns 4 query rows x 4 keys of
// the score tile and 4 rows x D/16 columns of the output accumulator.  With
// lengths >= 1, key tiles past the valid prefix (and, when causal, past the
// block's last query position) are skipped: their weights are exactly 0.
//
// What bounds it on this card: operations.  4 * S * T * D FLOP per (b, head)
// against 2 * (S + T) * D elements moved: at the Marian encoder's S = T = 512
// that is 128 FLOP/byte in float32, above the H100's ~20 FLOP/byte balance
// point for float32 outside the tensor cores.  At short sentences (S ~ 20)
// it is launch latency.
//
// What this simple design leaves on the table: the products run as float32
// FMAs on the CUDA cores from shared memory (8 shared loads per 16 FMAs), not
// on the tensor cores; there is no wgmma, no TMA and no double-buffered
// cp.async pipeline, so a tile's loads do not overlap the previous tile's
// math.  Porting the two products to wgmma (bf16 inputs, or TF32 where the
// tolerance allows) with a TMA-fed ring of K/V tiles is the later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr float kMasked = -1e30f;  // score of a masked key (NEG_INF there)

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

// sum / max over the 16 threads of a half-warp that share a query row
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile kBQ x (D+1), k tile kBK x (D+1), v tile kBK x D, p kBQ x (kBK+1)
  return sizeof(float) *
         (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ lengths,
                           T* __restrict__ out, int S, int T_len, int Hkv,
                           int rep, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh,
                           float scale, int causal) {
  constexpr int Dp = D + 1;    // padded rows: column reads hit distinct banks
  constexpr int Pp = kBK + 1;
  constexpr int NJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // kBQ x Dp
  float* k_s = q_s + kBQ * Dp;     // kBK x Dp
  float* v_s = k_s + kBK * Dp;     // kBK x D
  float* p_s = v_s + kBK * D;      // kBQ x Pp

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / Hkv;
  const int g = blockIdx.y % Hkv;
  const int rows = S * rep;        // flattened (position, grouped head)
  const int row0 = blockIdx.x * kBQ;
  const int len = lengths != nullptr ? lengths[b] : T_len;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int f = row0 + r;
    float x = 0.f;
    if (f < rows) {
      const int s = f / rep, h = g * rep + f % rep;
      x = to_f32(q[b * q_sb + (int64_t)s * q_ss + (int64_t)h * q_sh + d]);
    }
    q_s[r * Dp + d] = x;
  }

  int qpos[4];
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = min(row0 + ty + 16 * i, rows - 1) / rep;
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c] = 0.f;
  }

  // Keys [0, kv_end) are visited.  With len >= 1 every row has key 0 valid,
  // so keys past the prefix (and, causal, past the block's last position)
  // get weight exactly 0 and are skipped; with len <= 0 all T are visited.
  int kv_end = T_len;
  if (len > 0) {
    kv_end = min(len, T_len);
    if (causal) {
      const int last_pos = (min(row0 + kBQ, rows) - 1) / rep;
      kv_end = min(kv_end, last_pos + 1);
    }
  }

  const T* kb = k + b * k_sb + (int64_t)g * k_sh;
  const T* vb = v + b * v_sb + (int64_t)g * v_sh;
  for (int t0 = 0; t0 < kv_end; t0 += kBK) {
    __syncthreads();  // previous tile no longer read (and q tile written)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int slot = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (slot < T_len) {
        kx = to_f32(kb[(int64_t)slot * k_ss + d]);
        vx = to_f32(vb[(int64_t)slot * v_ss + d]);
      }
      k_s[j * Dp + d] = kx;
      v_s[j * D + d] = vx;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * Dp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = k_s[(tx + 16 * j) * Dp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + tx + 16 * j;
        float s;
        if (key >= T_len)
          s = -INFINITY;  // past the keys: no weight at all
        else if (key >= len || (causal && key > qpos[i]))
          s = kMasked;
        else
          s = sc[i][j] * scale;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(ty + 16 * i) * Pp + tx + 16 * j] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * Pp + kk];
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const float vx = v_s[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vx, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = row0 + ty + 16 * i;
    if (f >= rows) continue;
    const int s = f / rep, h = g * rep + f % rep;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + b * o_sb + (int64_t)s * o_ss + (int64_t)h * o_sh;
#pragma unroll
    for (int c = 0; c < NJ; ++c) o[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int S, int T_len,
                   int Hkv, int rep, const int64_t* st, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  // raised once per instantiation, at its first launch (so never inside a
  // graph capture that replays launches made before it)
  static bool smem_raised = false;
  if (smem > 48 * 1024 && !smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_raised = true;
  }
  const dim3 grid((S * rep + kBQ - 1) / kBQ, B * Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, T_len, Hkv,
      rep, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* lengths, void* out, int B, int S, int T_len,
                       int Hkv, int rep, const int64_t* st, float scale,
                       int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, out, B, S, T_len, Hkv, rep, st,
                           scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, B, S, T_len, Hkv, rep, st,
                           scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, B, S, T_len, Hkv, rep, st,
                           scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, B, S, T_len, Hkv, rep, st,
                            scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements, ordered q (batch, seq, head), k (...), v (...),
// out (...).  `lengths` may be null (every key valid).  dtype: 0 = float32,
// 1 = bfloat16.  Head dims 16, 32, 64 and 128 are compiled.  Returns the
// cudaError_t of the launch.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int S, int T_len, int H, int Hkv, int D, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_d<float>(D, q, k, v, lens, out, B, S, T_len, Hkv, rep, st,
                          scale, causal, s);
  else if (dtype == 1)
    e = dispatch_d<__nv_bfloat16>(D, q, k, v, lens, out, B, S, T_len, Hkv,
                                  rep, st, scale, causal, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
