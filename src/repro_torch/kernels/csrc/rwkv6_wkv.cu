// rwkv6_wkv for Hopper (sm_90a): the chunked WKV6 recurrence with a
// per-channel, data-dependent decay, carrying a (P x P) float32 state
// across chunks, run step by step on the CUDA cores and fed by TMA.
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
// The recurrence composes exactly over any blocking of the steps, so the
// kernel runs groups of its own (16 steps, the last one ragged) whatever
// the caller's chunk, and is held to the plain version at that chunk.
// Inside a group the decay factorises as above: r e^{cum_{t-1}} and
// k e^{-cum} are finite only because the caller clamps |log w| <= 2.5 per
// step (LOG_DECAY_CLAMP, models/layers/rwkv6.py), so a factorised block
// never exceeds 32 steps (e^{2.5 * 32} = e^80 < FLT_MAX); 16 steps keep
// every factor within e^{+-40}.
//
// Layout: r, k, v, log_w and y are (B, S, H, P) float32, addressed through
// element strides with the last dimension contiguous and base and strides
// 16-byte aligned, as TMA needs (so the model's (B, S, D) projections are
// read as they are, without the TPU wrapper's transposes); u is (H, P); s0
// and s_out are (B, H, P, P) contiguous, key-major (S[p][q], p over keys,
// q over values).  s0 may be null (zero state).  P is 16, 32, 64 or 128.
//
// What bounds it on this card: bytes.  Per chunk and head the chunked form
// reads 4 L P floats and writes L P, against about 2 L^2 P + 4 L P^2 FLOP:
// at L = 32, P = 64 that is 16 FLOP per byte, under the ~49 FLOP/byte
// balance of float32-accurate tensor-core products (3 x TF32 at 165
// TFLOP/s against 3.35 TB/s); the step-by-step form does about 4 P^2 FLOP
// a step and head, less still.
//
// What limits it is the CUDA cores' issue rate: two FFMAs per state
// element and step, an exponential per (step, channel) in the transform
// warp.  At rwkv6-3b's B=8 S=2048 it moves the bytes at under half the
// card's rate.  Tried and lost on the card (uncommitted probes, so no
// figures): the chunk products on the tensor cores fed by a 3-4 slot TMA
// ring (value-tiled blocks at the caller's chunk with two barriers a chunk
// instead of six: no faster, its latency being the chunk's chain of split,
// mma and shuffle steps, not its loads); the recurrence with S[:, q] in a
// pair of threads' registers (each warp's broadcast float4 loads cost four
// wavefronts: shared-memory bound); a per-step reduction of y over the
// lanes (its shuffle chain set the step's latency); four compute warps of
// 2 columns a lane (more instructions a step), or one of 8 columns (168
// registers a thread): both slower than two of 4 at B=8 S=2048.  The
// value-tiled mma.sync kernel this one replaced (3 x TF32 m16n8k8 chunk
// products at the caller's chunk, cp.async double buffering, six block
// barriers a chunk) was slower at every timed shape, from a prime prompt's
// chunk of 1 to B=8 S=2048 (PERF.md), and is gone.
//
// Every instantiation's shared-memory limit is raised on the first call,
// whatever its shape, so a CUDA graph captured later never meets one that
// was not set up.
//
// What it leaves for later: one transform per (b, h) rather than per block
// of value columns (the blocks of a head could share it through a
// cluster).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_common.cuh"

namespace {

// The recurrence step by step on the CUDA cores, in float32 (no TF32),
// fed by a ring of TMA loads: y_t = r_t . (S + diag(u) k_t v_t^T), S <-
// diag(w_t) S + k_t v_t^T.  Steps come in groups of cores::KL (one ring
// slot each); inside a group the decay factorises as in the chunked form,
// so a step costs two FFMAs per state element:
//   S^  = S_group_start + sum_{j<t} k'_j v_j^T,  k'_j = k_j e^{-cum_j}
//   y_t = (r_t e^{cum_{t-1}}) . S^ + (r_t . u k_t) v_t
//   S_next_group = diag(e^{cum_L}) S^
// A block owns one (b, h) and QT value columns, and has four warps:
//   * two compute warps (0, 1), each with half the columns: lane (pg, qg)
//     holds a (P/8) x CO block of S^ (channels in runs of up to 4, CO
//     columns), so a step's r', k' and v loads are few and wide (a phase
//     of 8 lanes reads distinct 16-byte pieces, or one broadcast); the
//     products' partial sums over its channels, four steps at a time, are
//     reduce-scattered over the 8 lanes of a column group (three shuffle
//     levels, off the steps' own dependence chain), each lane ending with
//     CO / 2 columns of one step;
//   * a transform warp (2) that turns a landed group's r, k, log w into
//     r', k' (in place), e^{cum_L} and the bonus sums r . u k, a group
//     ahead of the compute warps;
//   * a producer warp (3) whose lane 0 keeps STAGES groups of r, k, log w
//     and v rows in flight by TMA.
// No block barrier at all: the warps meet on mbarriers only.  Rows past S
// arrive zero-filled, so a ragged last group needs no branch.  Shared
// memory: STAGES = 3 slots of KL = 16 rows of r, k, log w (P) and v (QT)
// plus e^{cum_L} and the bonus sums: at P = 64, QT = 32, 14.7 KB a slot,
// 44 KB a block, five blocks (two heads and a half) per SM; at P = 128,
// 27.3 KB a slot, 82 KB a block, two per SM, and a lane's block of S^ is
// 16 x 4 registers.
namespace cores {
constexpr int KL = 16;           // steps per group (ring slot)
constexpr int STAGES = 3;
constexpr int kThreads = 128;    // two compute warps, a transform, a producer
__host__ __device__ constexpr int qt(int p) { return p < 32 ? p : 32; }
// floats of a slot: r, k, log w (KL x P), v (KL x QT), then e^{cum_L} (P)
// and the bonus sums (KL), rounded up to 128 bytes for the next slot's TMA
__host__ __device__ constexpr int slot_floats(int p) {
  return (KL * (3 * p + qt(p)) + p + KL + 31) / 32 * 32;
}
__host__ __device__ constexpr size_t smem_bytes(int p) {
  return 4 * (size_t)STAGES * slot_floats(p) + 3 * STAGES * 8 + 128;
}
}  // namespace cores

template <int P>
__global__ void __launch_bounds__(cores::kThreads)
    rwkv6_wkv_kernel(const __grid_constant__ CUtensorMap rmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap wmap,
                           int r_order, int k_order, int v_order,
                           int w_order, const float* __restrict__ u,
                           const float* __restrict__ s0,
                           float* __restrict__ y, float* __restrict__ s_out,
                           int S, int H, int64_t y_sb, int64_t y_ss,
                           int64_t y_sh) {
  namespace hw = repro::sm90;
  using cores::KL;
  using cores::STAGES;
  constexpr int QT = cores::qt(P), SLOT = cores::slot_floats(P);
  constexpr int CH = P / 8, CO = QT / 8;     // a lane's block of S^
  constexpr int R = CH < 4 ? CH : 4;         // channels per run
  constexpr int NR = CH / R;                 // runs
  static_assert(CO == 4 || CO == 2, "8 lanes reduce 4 or 2 columns");
  extern __shared__ unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * SLOT);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;

  const int n_qt = P / QT;
  const int b = blockIdx.x / (H * n_qt), h = blockIdx.x / n_qt % H;
  const int q0 = blockIdx.x % n_qt * QT;
  const int ngrp = (S + KL - 1) / KL;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&ready[s], 32);
      hw::mbar_init(&empty[s], 64);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 3) {
    // ---- producer: lane 0 keeps STAGES groups in flight ----
    if (lane != 0) return;
    hw::tma_prefetch_map(&rmap);
    hw::tma_prefetch_map(&kmap);
    hw::tma_prefetch_map(&vmap);
    hw::tma_prefetch_map(&wmap);
    for (int c = 0; c < ngrp; ++c) {
      const int st = c % STAGES, t0 = c * KL;
      hw::mbar_wait(&empty[st], ((c / STAGES) & 1) ^ 1);
      hw::mbar_expect_tx(&full[st], 4 * KL * (3 * P + QT));
      float* slot = smem + st * SLOT;
      hw::tma_load_rows(slot, &rmap, &full[st], r_order, 0, t0, h, b);
      hw::tma_load_rows(slot + KL * P, &kmap, &full[st], k_order, 0, t0, h,
                        b);
      hw::tma_load_rows(slot + 2 * KL * P, &wmap, &full[st], w_order, 0, t0,
                        h, b);
      hw::tma_load_rows(slot + 3 * KL * P, &vmap, &full[st], v_order, q0,
                        t0, h, b);
    }
    return;
  }

  if (warp == 2) {
    // ---- transform: lane l owns channels l + 32 i.
    // Rows past S arrive zero-filled, so every step of a group is taken
    // as it is (a zero row gives zero r', k' and bonus), without branches
    // and with the channels' chains side by side ----
    constexpr int PL = P > 32 ? P / 32 : 1;
    float u_p[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i)
      u_p[i] = lane + 32 * i < P ? u[(int64_t)h * P + lane + 32 * i] : 0.f;
    for (int c = 0; c < ngrp; ++c) {
      const int st = c % STAGES;
      float* rs = smem + st * SLOT;
      float* ks = rs + KL * P;
      const float* ws = ks + KL * P;
      float* dec = rs + KL * (3 * P + QT);
      float* bonus = dec + P;
      hw::mbar_wait(&full[st], (c / STAGES) & 1);
      // one exponential a step: r' divides by the step before's e^{-cum}
      // (every factor within e^{+-40} under the clamp)
      float ruk[KL], run[PL], e_prev[PL];
#pragma unroll
      for (int i = 0; i < PL; ++i) run[i] = 0.f, e_prev[i] = 1.f;
#pragma unroll
      for (int t = 0; t < KL; ++t) {
        ruk[t] = 0.f;
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          const int pc = lane + 32 * i;
          if (pc >= P) break;
          run[i] += ws[t * P + pc];
          const float e_neg = expf(-run[i]);
          const float rv = rs[t * P + pc], kv = ks[t * P + pc];
          rs[t * P + pc] = __fdividef(rv, e_prev[i]);
          ks[t * P + pc] = kv * e_neg;
          e_prev[i] = e_neg;
          ruk[t] += rv * u_p[i] * kv;
        }
      }
#pragma unroll
      for (int i = 0; i < PL; ++i)
        if (lane + 32 * i < P) dec[lane + 32 * i] = expf(run[i]);
#pragma unroll
      for (int t = 0; t < KL; ++t) {
        float sum = ruk[t];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) bonus[t] = sum;
      }
      hw::fence_async_smem();  // r', k' written over what TMA refills
      hw::mbar_arrive(&ready[st]);
    }
    return;
  }

  // ---- compute warps: lane (pg, qg) of warp w, column group 4 w + qg --
  const int pg = lane % 8, qg = 4 * warp + lane / 8;
  const int64_t state_off = (int64_t)(b * H + h) * P * P;
  // channel of run j, element e: R pg + 8 R j + e; column CO qg + c
  auto chan = [&](int j, int e) { return R * pg + 8 * R * j + e; };
  float sv[CH][CO];
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int e = 0; e < R; ++e)
#pragma unroll
      for (int cc = 0; cc < CO; ++cc)
        sv[R * j + e][cc] =
            s0 != nullptr
                ? s0[state_off + chan(j, e) * P + q0 + CO * qg + cc]
                : 0.f;
  float* yb = y + b * y_sb + h * y_sh + q0;

  for (int c = 0; c < ngrp; ++c) {
    const int st = c % STAGES, t0 = c * KL, live = min(KL, S - t0);
    const float* rs = smem + st * SLOT;   // r'
    const float* ks = rs + KL * P;        // k'
    const float* vs = ks + 2 * KL * P;    // v (QT columns)
    const float* dec = vs + KL * QT;
    const float* bonus = dec + P;
    hw::mbar_wait(&ready[st], (c / STAGES) & 1);
    // four steps at a time: y_t's partial sums over this lane's channels
    // for each of its columns, then S^ += k'_t v_t; rows past `live` are
    // zero (TMA's fill), so a ragged last group adds nothing to S^
    for (int t4 = 0; t4 < live; t4 += 4) {
      float acc[4][CO];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t4 + u;
        float rv[CH], kv[CH], vq[CO];
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          if constexpr (R == 4) {
            const float4 r4 =
                *reinterpret_cast<const float4*>(rs + t * P + chan(j, 0));
            const float4 k4 =
                *reinterpret_cast<const float4*>(ks + t * P + chan(j, 0));
            rv[4 * j] = r4.x, rv[4 * j + 1] = r4.y, rv[4 * j + 2] = r4.z,
            rv[4 * j + 3] = r4.w;
            kv[4 * j] = k4.x, kv[4 * j + 1] = k4.y, kv[4 * j + 2] = k4.z,
            kv[4 * j + 3] = k4.w;
          } else {
            const float2 r2 =
                *reinterpret_cast<const float2*>(rs + t * P + chan(j, 0));
            const float2 k2 =
                *reinterpret_cast<const float2*>(ks + t * P + chan(j, 0));
            rv[2 * j] = r2.x, rv[2 * j + 1] = r2.y;
            kv[2 * j] = k2.x, kv[2 * j + 1] = k2.y;
          }
        }
        if constexpr (CO == 4) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(vs + t * QT + 4 * qg);
          vq[0] = v4.x, vq[1] = v4.y, vq[2] = v4.z, vq[3] = v4.w;
        } else {
          const float2 v2 =
              *reinterpret_cast<const float2*>(vs + t * QT + 2 * qg);
          vq[0] = v2.x, vq[1] = v2.y;
        }
#pragma unroll
        for (int cc = 0; cc < CO; ++cc) {
          acc[u][cc] = 0.f;
#pragma unroll
          for (int i = 0; i < CH; ++i) {
            acc[u][cc] = fmaf(rv[i], sv[i][cc], acc[u][cc]);
            sv[i][cc] = fmaf(kv[i], vq[cc], sv[i][cc]);
          }
        }
      }
      // reduce-scatter the 4 x CO sums over the 8 lanes of the column
      // group: bit 2 of pg keeps steps {0, 1} or {2, 3}, bit 1 one of
      // those, bit 0 half the columns; lane pg ends with step 2 b2 + b1
      // and CO / 2 columns from CO b0 / 2
      float* a = &acc[0][0];
      auto halve = [&](int mask, int n) {
        const bool up = (pg & mask) != 0;
#pragma unroll
        for (int i = 0; i < n / 2; ++i) {
          const float keep = up ? a[i + n / 2] : a[i];
          const float give = up ? a[i] : a[i + n / 2];
          a[i] = keep + __shfl_xor_sync(0xffffffffu, give, mask);
        }
      };
      halve(4, 4 * CO);
      halve(2, 2 * CO);
      halve(1, CO);
      const int t = t4 + 2 * (pg >> 2) + ((pg >> 1) & 1);
      const int col = CO * qg + (pg & 1) * (CO / 2);
      if (t < live) {
        float* yr = yb + (int64_t)(t0 + t) * y_ss + col;
        const float bt = bonus[t];
        if constexpr (CO == 4) {
          const float2 vv = *reinterpret_cast<const float2*>(vs + t * QT + col);
          *reinterpret_cast<float2*>(yr) =
              make_float2(fmaf(bt, vv.x, a[0]), fmaf(bt, vv.y, a[1]));
        } else {
          *yr = fmaf(bt, vs[t * QT + col], a[0]);
        }
      }
    }
    // S <- diag(e^{cum_L}) S^ for the next group
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < R; ++e) {
        const float d = dec[chan(j, e)];
#pragma unroll
        for (int cc = 0; cc < CO; ++cc) sv[R * j + e][cc] *= d;
      }
    hw::mbar_arrive(&empty[st]);  // the slot is read
  }
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int e = 0; e < R; ++e)
#pragma unroll
      for (int cc = 0; cc < CO; ++cc)
        s_out[state_off + chan(j, e) * P + q0 + CO * qg + cc] =
            sv[R * j + e][cc];
}

// Raise the shared-memory limit of every instantiation at once.
template <int P>
cudaError_t raise_one() {
  return cudaFuncSetAttribute(rwkv6_wkv_kernel<P>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)cores::smem_bytes(P));
}

cudaError_t raise_all() {
  cudaError_t e = raise_one<16>();
  if (e == cudaSuccess) e = raise_one<32>();
  if (e == cudaSuccess) e = raise_one<64>();
  if (e == cudaSuccess) e = raise_one<128>();
  return e;
}

}  // namespace

// Strides are in elements, ordered r (batch, seq, head), k, v, log_w, y;
// r, k, v and log_w are read through tensor maps (16-byte aligned base and
// strides).  u (H, P) and s0 / s_out (B, H, P, P) are contiguous; s0 may be
// null.  Groups of 16 steps, the last one ragged, whatever the caller's
// chunk.  P 16, 32, 64 or 128.  Returns the cudaError_t of the launch.
extern "C" int repro_rwkv6_wkv(
    const void* r, const void* k, const void* v, const void* log_w,
    const void* u, const void* s0, void* y, void* s_out, int B, int S, int H,
    int P, int64_t r_sb, int64_t r_ss, int64_t r_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t w_sb, int64_t w_ss, int64_t w_sh, int64_t y_sb, int64_t y_ss,
    int64_t y_sh, void* stream) {
  // first call, whatever its shape: every instantiation's limit, outside
  // any graph capture that later replays a launch of another shape
  static const cudaError_t smem_ready = raise_all();
  if (smem_ready != cudaSuccess) return (int)smem_ready;
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  auto launch = [&](auto fn, auto pc) {
    constexpr int PP = decltype(pc)::value;
    namespace hw = repro::sm90;
    CUtensorMap rmap, kmap, vmap, wmap;
    int ro, ko, vo, wo;
    cudaError_t e = hw::f32_rows_map(&rmap, r, PP, S, H, B, r_sb, r_ss, r_sh,
                                     PP, cores::KL, false, &ro);
    if (e == cudaSuccess)
      e = hw::f32_rows_map(&kmap, k, PP, S, H, B, k_sb, k_ss, k_sh, PP,
                           cores::KL, false, &ko);
    if (e == cudaSuccess)
      e = hw::f32_rows_map(&vmap, v, PP, S, H, B, v_sb, v_ss, v_sh,
                           cores::qt(PP), cores::KL, false, &vo);
    if (e == cudaSuccess)
      e = hw::f32_rows_map(&wmap, log_w, PP, S, H, B, w_sb, w_ss, w_sh, PP,
                           cores::KL, false, &wo);
    if (e != cudaSuccess) return (int)e;
    fn<<<B * H * (PP / cores::qt(PP)), cores::kThreads, cores::smem_bytes(PP),
         static_cast<cudaStream_t>(stream)>>>(
        rmap, kmap, vmap, wmap, ro, ko, vo, wo, static_cast<const float*>(u),
        static_cast<const float*>(s0), static_cast<float*>(y),
        static_cast<float*>(s_out), S, H, y_sb, y_ss, y_sh);
    return (int)cudaGetLastError();
  };
  switch (P) {
    case 16:
      return launch(rwkv6_wkv_kernel<16>, std::integral_constant<int, 16>());
    case 32:
      return launch(rwkv6_wkv_kernel<32>, std::integral_constant<int, 32>());
    case 64:
      return launch(rwkv6_wkv_kernel<64>, std::integral_constant<int, 64>());
    case 128:
      return launch(rwkv6_wkv_kernel<128>,
                    std::integral_constant<int, 128>());
    default:
      return (int)cudaErrorInvalidValue;
  }
}
