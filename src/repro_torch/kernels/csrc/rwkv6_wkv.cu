// rwkv6_wkv for Hopper (sm_90a): the chunked WKV6 recurrence with a
// per-channel, data-dependent decay, carrying a (P x P) float32 state
// across chunks.
//
// Replaces the Pallas TPU kernel `rwkv6_wkv` in
// src/repro/kernels/rwkv6_wkv.py (function at line 77, its pl.pallas_call
// at line 99, body `_wkv_kernel` at line 31).  It computes what that kernel
// computes, chunk by chunk (t, j index the L steps of a chunk; p, q the P
// channels):
//
//   cum_t    = sum_{i<=t} log w_i                       (per channel)
//   A[t,j]   = (r_t e^{cum_{t-1}}) . (k_j e^{-cum_j}),   j < t
//   y_t      = sum_j A[t,j] v_j + (r_t . u k_t) v_t + (r_t e^{cum_{t-1}}) S
//   S       <- diag(e^{cum_L}) S + sum_j (k_j e^{cum_L - cum_j}) v_j^T
//
// The decay-weighted r' and k' are finite only because the caller clamps
// |log w| <= 2.5 per step (LOG_DECAY_CLAMP, models/layers/rwkv6.py) and the
// chunk is at most 32 steps: e^{2.5 * 32} = e^80 < FLT_MAX (e^88.7).  The
// wrapper refuses longer chunks; nothing here enlarges the chunk.
//
// Layout: r, k, v, log_w and y are (B, S, H, P) float32, addressed through
// element strides with the last dimension contiguous (so the model's
// (B, S, D) projections are read as they are, without the TPU wrapper's
// transposes); u is (H, P); s0 and s_out are (B, H, P, P) contiguous,
// key-major (S[p][q], p over keys, q over values).  s0 may be null (zero
// state).
//
// Grid: one block of 256 threads per (b, h), looping over the S / L chunks
// in order.  The state stays in shared memory for the whole sequence; each
// chunk's r, k, v and log w tiles are staged in shared memory, and every
// product runs as float32 FMAs on the CUDA cores:
//   1. stage the L x P tiles;
//   2. one thread per channel runs the prefix sum over the chunk and
//      writes r', k', the state-update weights k e^{cum_L - cum} and the
//      bonus products r u k;
//   3. the strictly lower (L x L) scores A and the per-step bonus;
//   4. y = A v + bonus v + r' S, written straight to device memory;
//   5. the state update.
// L is a runtime argument from 1 to 32 (pick_chunk gives 1 for a prime
// prompt length), so no shape needs padding.
//
// What bounds it on this card: both limits at once.  Per chunk and (b, h)
// it reads 4 L P floats and writes L P, against about 2 L^2 P + 4 L P^2
// FLOP: at L = 32, P = 64 that is 16 FLOP per byte, next to the H100's
// ~20 FLOP/byte balance for float32 outside the tensor cores.  This one is far from either: at B = 1 only H
// blocks run (40 for rwkv6-3b on 132 SMs), step 2 keeps P of 256 threads
// busy, and no load overlaps any math.  Moving the three products to wgmma
// (TF32 or bf16 where the tolerance allows), splitting a sequence's chunks
// over several blocks with a second pass for the carried state, and
// double-buffering the tile loads are the later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 32;   // e^{2.5 * 32} stays finite in float32
constexpr int kMaxP = 128;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// floats of dynamic shared memory for head size P and chunk L
__host__ __device__ constexpr size_t smem_floats(int P, int L) {
  return (size_t)P * P            // state
         + 4 * (size_t)L * P      // r', k weights, v, log w / bonus terms
         + (size_t)L * (P + 1)    // k' (padded rows: no bank conflicts)
         + (size_t)L * (L + 1)    // scores A
         + L + P;                 // bonus, e^{cum_L}
}

__global__ void __launch_bounds__(kThreads)
    rwkv6_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     float* __restrict__ y, float* __restrict__ s_out, int S,
                     int H, int P, int L, int64_t r_sb, int64_t r_ss,
                     int64_t r_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                     int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t w_sb,
                     int64_t w_ss, int64_t w_sh, int64_t y_sb, int64_t y_ss,
                     int64_t y_sh) {
  extern __shared__ float smem[];
  const int Pk = P + 1, La = L + 1;
  float* st = smem;              // P x P state S[p][q]
  float* rd = st + P * P;        // L x P   r, then r e^{cum_{t-1}}
  float* kw = rd + L * P;        // L x P   k, then k e^{cum_L - cum_t}
  float* vs = kw + L * P;        // L x P   v
  float* ruk = vs + L * P;       // L x P   log w, then r u k
  float* ki = ruk + L * P;       // L x Pk  k e^{-cum_t}
  float* a = ki + L * Pk;        // L x La  scores
  float* bonus = a + L * La;     // L
  float* dec = bonus + L;        // P       e^{cum_L}

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int64_t state_off = (int64_t)bh * P * P;
  for (int i = tid; i < P * P; i += kThreads)
    st[i] = s0 != nullptr ? s0[state_off + i] : 0.f;
  const float u_p = tid < P ? u[(int64_t)h * P + tid] : 0.f;

  const float* rb = r + b * r_sb + h * r_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* wb = lw + b * w_sb + h * w_sh;
  float* yb = y + b * y_sb + h * y_sh;
  const int warp = tid / 32, lane = tid % 32;

  for (int t0 = 0; t0 < S; t0 += L) {
    // 1. stage the chunk (the previous chunk's last reads ended at a sync)
    for (int i = tid; i < L * P; i += kThreads) {
      const int64_t s = t0 + i / P;
      const int p = i % P;
      rd[i] = rb[s * r_ss + p];
      kw[i] = kb[s * k_ss + p];
      vs[i] = vb[s * v_ss + p];
      ruk[i] = wb[s * w_ss + p];
    }
    __syncthreads();

    // 2. per-channel prefix sums of the log decay and the weighted tiles
    if (tid < P) {
      const int p = tid;
      float cl = 0.f;
      for (int t = 0; t < L; ++t) cl += ruk[t * P + p];
      float c = 0.f;
      for (int t = 0; t < L; ++t) {
        const int at = t * P + p;
        const float cp = c;
        c += ruk[at];
        const float rv = rd[at], kv = kw[at];
        rd[at] = rv * expf(cp);
        ki[t * Pk + p] = kv * expf(-c);
        kw[at] = kv * expf(cl - c);
        ruk[at] = rv * u_p * kv;
      }
      dec[p] = expf(cl);
    }
    __syncthreads();

    // 3. bonus[t] = r_t . u k_t ;  A[t][j] = r'_t . k'_j for j < t
    for (int t = warp; t < L; t += kThreads / 32) {
      float sum = 0.f;
      for (int p = lane; p < P; p += 32) sum += ruk[t * P + p];
      sum = warp_sum(sum);
      if (lane == 0) bonus[t] = sum;
    }
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, j = i % L;
      float acc = 0.f;
      if (j < t) {
        const float* rt = rd + t * P;
        const float* kj = ki + j * Pk;
        for (int p = 0; p < P; ++p) acc = fmaf(rt[p], kj[p], acc);
      }
      a[t * La + j] = acc;
    }
    __syncthreads();

    // 4. y_t = sum_{j<t} A[t][j] v_j + bonus_t v_t + r'_t S
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P, q = i % P;
      float acc = bonus[t] * vs[t * P + q];
      for (int j = 0; j < t; ++j) acc = fmaf(a[t * La + j], vs[j * P + q], acc);
      const float* rt = rd + t * P;
      for (int p = 0; p < P; ++p) acc = fmaf(rt[p], st[p * P + q], acc);
      yb[(int64_t)(t0 + t) * y_ss + q] = acc;
    }
    __syncthreads();   // every read of the old state is done

    // 5. S <- diag(e^{cum_L}) S + sum_t (k_t e^{cum_L - cum_t}) v_t^T
    for (int i = tid; i < P * P; i += kThreads) {
      const int p = i / P, q = i % P;
      float acc = st[i] * dec[p];
      for (int t = 0; t < L; ++t) acc = fmaf(kw[t * P + p], vs[t * P + q], acc);
      st[i] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < P * P; i += kThreads) s_out[state_off + i] = st[i];
}

}  // namespace

// Strides are in elements, ordered r (batch, seq, head), k, v, log_w, y.
// u (H, P) and s0 / s_out (B, H, P, P) are contiguous; s0 may be null.
// Needs 1 <= L <= 32, S % L == 0 and 1 <= P <= 128.  Returns the
// cudaError_t of the launch.
extern "C" int repro_rwkv6_wkv(
    const void* r, const void* k, const void* v, const void* log_w,
    const void* u, const void* s0, void* y, void* s_out, int B, int S, int H,
    int P, int L, int64_t r_sb, int64_t r_ss, int64_t r_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t w_sb, int64_t w_ss, int64_t w_sh, int64_t y_sb, int64_t y_ss,
    int64_t y_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kMaxP || L <= 0 ||
      L > kMaxChunk || S % L != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(P, L);
  // raised once, to the most any (P, L) asks for, at the first launch that
  // needs more than the default 48 KB (never inside a graph capture that
  // replays launches made before it)
  static bool smem_raised = false;
  if (smem > 48 * 1024 && !smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * smem_floats(kMaxP, kMaxChunk)));
    if (e != cudaSuccess) return (int)e;
    smem_raised = true;
  }
  rwkv6_wkv_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(log_w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), S, H, P, L, r_sb,
      r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh, y_sb,
      y_ss, y_sh);
  return (int)cudaGetLastError();
}
