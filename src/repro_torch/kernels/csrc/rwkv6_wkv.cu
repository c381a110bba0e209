// rwkv6_wkv for Hopper (sm_90a): the chunked WKV6 recurrence with a
// per-channel, data-dependent decay, carrying a (P x P) float32 state
// across chunks, with its three chunk products on the tensor cores.
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
// element strides with the last dimension contiguous and rows 16-byte
// aligned (so the model's (B, S, D) projections are read as they are,
// without the TPU wrapper's transposes); u is (H, P); s0 and s_out are
// (B, H, P, P) contiguous, key-major (S[p][q], p over keys, q over values).
// s0 may be null (zero state).  P is 16, 32, 64 or 128.
//
// What bounds it on this card: bytes at the serving shape, both at long
// prefill.  Per chunk and head it reads 4 L P floats and writes L P,
// against about 2 L^2 P + 4 L P^2 FLOP: at L = 32, P = 64 that is 16
// FLOP per byte, under the ~49 FLOP/byte balance of float32-accurate
// tensor-core products (3 x TF32 at 165 TFLOP/s against 3.35 TB/s).
//
// Design:
//   * Value-tiled blocks.  Column q of y and of the state depends only on
//     column q of v, so a block owns one (b, h) and a tile of PT value
//     columns (16, 32 or 64; `wkv_plan` in rwkv6_wkv.py picks it for a
//     block per two SMs where the shape has them) and runs the sequence's
//     chunks in order with its (P x PT) state tile in shared memory: no
//     second pass, no state traffic between blocks.  Each block recomputes
//     the chunk's shared part (prefix sums, r', k', A) for itself; the
//     tiles of one (b, h) are adjacent in launch order, so their r / k /
//     log w reads meet in L2.
//   * Prefix sums over the whole block: thread (p, segment) sums its run
//     of steps of channel p, the runs' totals are combined through shared
//     memory, and each thread then writes r' = r e^{cum_{t-1}}, k' =
//     k e^{-cum}, the state weights k e^{cum_L - cum} and the bonus terms
//     r u k for its steps; one warp per step then sums those over the
//     channels.
//   * Tensor cores: A = r' k'^T, y = A v + r' S (plus the bonus
//     (r . u k) v_t, added in registers) and the state update (k w)^T v
//     run on mma.sync m16n8k8 as 3 x TF32 (mma_common.cuh), which keeps
//     float32 accuracy where one TF32 product misses the 2e-4 tolerance by
//     250x.  The split keeps float32's exponent range, so k' up to e^80 and
//     r' down to e^-80 go in as they are.  A (at most 32 x 32) passes
//     through shared memory so its tiles, y's (row tile, value columns)
//     tiles and the state's (16-row, value half) tiles are each spread over
//     the eight warps; even and odd k steps accumulate apart, two chains
//     per product.  Row strides (r', k': P + 4; k w: P + 8; v, state:
//     PT + 8; A: 36) make every fragment load conflict-free.
//   * Chunk c + 1's r, k, v and log w are staged with 16-byte cp.async.cg
//     in a second buffer while chunk c computes; the tiles' rows past L
//     are zeroed once and never loaded, so any L from 1 to 32 runs
//     without padding (pick_chunk gives 1 for a prime prompt length).  At
//     L = 1 the same tiles carry one live row: the chunk's products stay
//     on the tensor cores, at six barriers per step.
//   * Every instantiation's shared-memory limit is raised on the first
//     call of the C entry point, whatever its shape, so a CUDA graph
//     captured later never meets one that was not set up.
//
// What it leaves for later: wgmma and TMA; splitting the staged tiles
// into TF32 hi/lo once per block.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::FragA;
using repro::FragB;
using repro::mma_3xtf32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 32;   // e^{2.5 * 32} stays finite in float32
constexpr int kMaxP = 128;
constexpr int AS = kMaxChunk + 4;  // row stride of A

__host__ __device__ constexpr int round16(int l) { return (l + 15) / 16 * 16; }

// floats of one stage buffer: r / r', log w / k', k / k w, v
__host__ __device__ constexpr size_t stage_floats(int p, int pt, int lr) {
  return (size_t)lr * (2 * (p + 4) + (p + 8) + (pt + 8));
}

// bytes of dynamic shared memory: two stage buffers, A, the state tile,
// the segment sums, the bonus terms and their sums, and e^{cum_L}
__host__ __device__ constexpr size_t smem_bytes(int p, int pt, int l) {
  return 4 * (2 * stage_floats(p, pt, round16(l)) + (size_t)kMaxChunk * AS +
              (size_t)p * (pt + 8) + kThreads + (size_t)round16(l) * (p + 1) +
              p);
}

template <int PT>
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
  constexpr int VS = PT + 8, SS = PT + 8, NT = PT / 8;
  constexpr int NG = NT < 4 ? NT : 4, GN = NT / NG;  // y's value groups
  const int RS = P + 4, KS = P + 8;
  const int LR = round16(L);
  extern __shared__ __align__(16) float smem[];
  const size_t stage = stage_floats(P, PT, LR);
  float* as = smem + 2 * stage;       // LR x AS      A, strictly lower
  float* st = as + kMaxChunk * AS;    // P x SS       state S[p][q]
  float* segsum = st + P * SS;        // kThreads     per-run log-w sums
  float* ruk = segsum + kThreads;     // LR x P       r u k per step, channel
  float* bonus = ruk + LR * P;        // LR           r_t . u k_t
  float* dec = bonus + LR;            // P            e^{cum_L}

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_pt = P / PT;
  const int pt = blockIdx.x % n_pt;
  const int bh = blockIdx.x / n_pt;
  const int b = bh / H, h = bh % H;
  const int q0 = pt * PT;

  const float* rb = r + b * r_sb + h * r_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh + q0;
  const float* wb = lw + b * w_sb + h * w_sh;
  float* yb = y + b * y_sb + h * y_sh + q0;

  // rows past L stay zero in both buffers: no chunk writes them
  for (int i = tid; i < 2 * (LR - L) * (int)(stage / LR); i += kThreads) {
    const int buf = i / ((LR - L) * (int)(stage / LR));
    const int rest = i % ((LR - L) * (int)(stage / LR));
    float* base = smem + buf * stage;
    const int rows = LR - L, k_end = 2 * RS + KS;
    const int col = rest / rows, row = L + rest % rows;
    if (col < RS) base[row * RS + col] = 0.f;
    else if (col < 2 * RS) base[LR * RS + row * RS + col - RS] = 0.f;
    else if (col < k_end) base[2 * LR * RS + row * KS + col - 2 * RS] = 0.f;
    else base[2 * LR * RS + LR * KS + row * VS + col - k_end] = 0.f;
  }

  const int kp_shift = __ffs(P / 4) - 1;   // log2 of a key row's pieces
  auto load_chunk = [&](int buf, int t0) {
    float* rs = smem + buf * stage;
    float* ws = rs + LR * RS;
    float* ks = ws + LR * RS;
    float* vs = ks + LR * KS;
    for (int i = tid; i < L << kp_shift; i += kThreads) {
      const int row = i >> kp_shift, c = (i & ((1 << kp_shift) - 1)) * 4;
      const int64_t s = t0 + row;
      cp_async16(rs + row * RS + c, rb + s * r_ss + c, 16);
      cp_async16(ws + row * RS + c, wb + s * w_ss + c, 16);
      cp_async16(ks + row * KS + c, kb + s * k_ss + c, 16);
    }
    constexpr int VP = PT / 4;
    for (int i = tid; i < L * VP; i += kThreads) {
      const int row = i / VP, c = (i % VP) * 4;
      cp_async16(vs + row * VS + c, vb + (int64_t)(t0 + row) * v_ss + c, 16);
    }
  };

  const int n_chunks = S / L;
  load_chunk(0, 0);
  cp_async_commit();

  const int64_t state_off = (int64_t)(b * H + h) * P * P;
  for (int i = tid; i < P * PT; i += kThreads) {
    const int p = i / PT, q = i % PT;
    st[p * SS + q] = s0 != nullptr ? s0[state_off + p * P + q0 + q] : 0.f;
  }
  // prefix-sum role: channel p, run `seg` of the chunk's steps
  const int pc = tid % P, seg = tid / P, n_seg = kThreads / P;
  const float u_p = u[(int64_t)h * P + pc];

  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // chunk c - 1 is done with its buffer and the state
    if (c + 1 < n_chunks) {
      load_chunk((c + 1) & 1, (c + 1) * L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c visible to every warp
    float* rs = smem + (c & 1) * stage;  // r, then r'
    float* ws = rs + LR * RS;            // log w, then k'
    float* ks = ws + LR * RS;            // k, then k w
    const float* vs = ks + LR * KS;

    // 1. prefix sums: each thread sums its run, the runs are combined
    const int run = (L + n_seg - 1) / n_seg;
    const int lo = min(L, seg * run), hi = min(L, lo + run);
    {
      float sum = 0.f;
      for (int t = lo; t < hi; ++t) sum += ws[t * RS + pc];
      segsum[seg * P + pc] = sum;
    }
    __syncthreads();
    {
      float off = 0.f;
      for (int s = 0; s < seg; ++s) off += segsum[s * P + pc];
      float total = off;   // the same sums in the same order: cum_{L-1}
      for (int s = seg; s < n_seg; ++s) total += segsum[s * P + pc];
      if (seg == 0) dec[pc] = expf(total);
      float loc = 0.f;
      for (int t = lo; t < hi; ++t) {
        const int at = t * RS + pc;
        const float cprev = off + loc;
        loc += ws[at];
        const float cum = off + loc;
        const float rv = rs[at], kv = ks[t * KS + pc];
        rs[at] = rv * expf(cprev);
        ws[at] = kv * expf(-cum);
        ks[t * KS + pc] = kv * expf(total - cum);
        ruk[t * P + pc] = rv * u_p * kv;
      }
    }
    __syncthreads();

    // 2. A tiles (16 x 8), one per warp: A[t][j] = r'_t . k'_j for j < t,
    // zero elsewhere (a tile with no j < t < L skips the product); even and
    // odd k steps accumulate apart (two chains).  Then the bonus r . u k of
    // each step, summed over the channels by one warp per step
    const int RT = LR / 16;
    const int njt0 = (min(16, L) + 7) / 8;
    const int njt1 = RT > 1 ? (min(32, L) + 7) / 8 : 0;
    if (warp < njt0 + njt1) {
      const int rt = warp < njt0 ? 0 : 1;
      const int jt = warp < njt0 ? warp : warp - njt0;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if (8 * jt < min(16 * rt + 16, L) - 1) {
        const float* ra = rs + (16 * rt + g) * RS + t4;
        const float* kj = ws + (8 * jt + g) * RS + t4;
        auto step = [&](int kk, float (&out)[4]) {
          FragA a;
          a.set(ra[8 * kk], ra[8 * RS + 8 * kk], ra[8 * kk + 4],
                ra[8 * RS + 8 * kk + 4]);
          FragB f;
          f.set(kj[8 * kk], kj[8 * kk + 4]);
          mma_3xtf32(out, a, f);
        };
        #pragma unroll 4
        for (int kk = 0; kk < P / 8; kk += 2) {   // P / 8 is even
          step(kk, acc[0]);
          step(kk + 1, acc[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 16 * rt + g + 8 * i;
        float val[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * jt + 2 * t4 + e;
          val[e] = (t < L && j < t) ? acc[0][2 * i + e] + acc[1][2 * i + e]
                                    : 0.f;
        }
        *reinterpret_cast<float2*>(as + t * AS + 8 * jt + 2 * t4) =
            make_float2(val[0], val[1]);
      }
    }
    for (int t = warp; t < L; t += kWarps) {
      float sum = 0.f;
      for (int p = lane; p < P; p += 32) sum += ruk[t * P + p];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) bonus[t] = sum;
    }
    __syncthreads();

    // 3. y = A v + r' S + bonus v for (16-row tile, group of GN value
    // n-tiles) units
    const int t_base = c * L;
    for (int unit = warp; unit < NG * RT; unit += kWarps) {
      const int r0 = 16 * (unit / NG), nt0 = (unit % NG) * GN;
      float acc[2][GN][4];
#pragma unroll
      for (int n = 0; n < GN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][n][e] = acc[1][n][e] = 0.f;
      const float* ra = rs + (r0 + g) * RS + t4;
      auto inter_step = [&](int kk, float (&out)[GN][4]) {
        FragA a;
        a.set(ra[8 * kk], ra[8 * RS + 8 * kk], ra[8 * kk + 4],
              ra[8 * RS + 8 * kk + 4]);
        const float* sk = st + (8 * kk + t4) * SS + g + 8 * nt0;
#pragma unroll
        for (int n = 0; n < GN; ++n) {
          FragB f;
          f.set(sk[8 * n], sk[4 * SS + 8 * n]);
          mma_3xtf32(out[n], a, f);
        }
      };
      #pragma unroll 4
      for (int kk = 0; kk < P / 8; kk += 2) {   // P / 8 is even
        inter_step(kk, acc[0]);
        inter_step(kk + 1, acc[1]);
      }
      const float* aa = as + (r0 + g) * AS + t4;
      auto intra_step = [&](int kk, float (&out)[GN][4]) {
        FragA a;
        a.set(aa[8 * kk], aa[8 * AS + 8 * kk], aa[8 * kk + 4],
              aa[8 * AS + 8 * kk + 4]);
        const float* vk = vs + (8 * kk + t4) * VS + g + 8 * nt0;
#pragma unroll
        for (int n = 0; n < GN; ++n) {
          FragB f;
          f.set(vk[8 * n], vk[4 * VS + 8 * n]);
          mma_3xtf32(out[n], a, f);
        }
      };
      const int njt = (min(r0 + 16, L) + 7) / 8;
      for (int kk = 0; kk < njt; kk += 2) {
        intra_step(kk, acc[0]);
        if (kk + 1 < njt) intra_step(kk + 1, acc[1]);
      }
      // the bonus term (r_t . u k_t) v_t, then the store
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = r0 + g + 8 * i;
        if (t >= L) continue;
        const float bt = bonus[t];
        const float* vt = vs + t * VS + 8 * nt0 + 2 * t4;
        float* yr = yb + (int64_t)(t_base + t) * y_ss + 8 * nt0 + 2 * t4;
#pragma unroll
        for (int n = 0; n < GN; ++n) {
          const float2 vv = *reinterpret_cast<const float2*>(vt + 8 * n);
          *reinterpret_cast<float2*>(yr + 8 * n) = make_float2(
              acc[0][n][2 * i] + acc[1][n][2 * i] + bt * vv.x,
              acc[0][n][2 * i + 1] + acc[1][n][2 * i + 1] + bt * vv.y);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // 4. S <- diag(e^{cum_L}) S + (k w)^T v, (16 key rows, value half) units
    for (int unit = warp; unit < (P / 16) * 2; unit += kWarps) {
      constexpr int NH = NT / 2;
      const int p0 = 16 * (unit / 2) + g, p1 = p0 + 8;
      float* s_r = st + 2 * t4 + 8 * NH * (unit % 2);
      const float d0 = dec[p0], d1 = dec[p1];
      float acc[2][NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const float2 x0 = *reinterpret_cast<const float2*>(s_r + p0 * SS + 8 * n);
        const float2 x1 = *reinterpret_cast<const float2*>(s_r + p1 * SS + 8 * n);
        acc[0][n][0] = x0.x * d0;
        acc[0][n][1] = x0.y * d0;
        acc[0][n][2] = x1.x * d1;
        acc[0][n][3] = x1.y * d1;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[1][n][e] = 0.f;
      }
      const float* vh = vs + g + 8 * NH * (unit % 2);
      auto step = [&](int kk, float (&out)[NH][4]) {
        const float* kt = ks + (8 * kk + t4) * KS;
        FragA a;
        a.set(kt[p0], kt[p1], kt[4 * KS + p0], kt[4 * KS + p1]);
        const float* vk = vh + (8 * kk + t4) * VS;
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          FragB f;
          f.set(vk[8 * n], vk[4 * VS + 8 * n]);
          mma_3xtf32(out[n], a, f);
        }
      };
      const int kend = (L + 7) / 8;
      for (int kk = 0; kk < kend; kk += 2) {
        step(kk, acc[0]);
        if (kk + 1 < kend) step(kk + 1, acc[1]);
      }
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        *reinterpret_cast<float2*>(s_r + p0 * SS + 8 * n) = make_float2(
            acc[0][n][0] + acc[1][n][0], acc[0][n][1] + acc[1][n][1]);
        *reinterpret_cast<float2*>(s_r + p1 * SS + 8 * n) = make_float2(
            acc[0][n][2] + acc[1][n][2], acc[0][n][3] + acc[1][n][3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * PT; i += kThreads) {
    const int p = i / PT, q = i % PT;
    s_out[state_off + p * P + q0 + q] = st[p * SS + q];
  }
}

using KernelFn = void (*)(const float*, const float*, const float*,
                          const float*, const float*, const float*, float*,
                          float*, int, int, int, int, int64_t, int64_t,
                          int64_t, int64_t, int64_t, int64_t, int64_t,
                          int64_t, int64_t, int64_t, int64_t, int64_t,
                          int64_t, int64_t, int64_t);

struct Variant {
  int pt;
  KernelFn fn;
};
const Variant kVariants[] = {{16, rwkv6_wkv_kernel<16>},
                             {32, rwkv6_wkv_kernel<32>},
                             {64, rwkv6_wkv_kernel<64>}};

// Raise the shared-memory limit of every instantiation at once, to the
// most any (P, L) asks for.
cudaError_t raise_all() {
  for (const Variant& var : kVariants) {
    const cudaError_t e = cudaFuncSetAttribute(
        var.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxP, var.pt, kMaxChunk));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Strides are in elements, ordered r (batch, seq, head), k, v, log_w, y.
// u (H, P) and s0 / s_out (B, H, P, P) are contiguous; s0 may be null.
// p_tile (16, 32 or 64, dividing P) is a block's share of the value
// columns (wkv_plan in rwkv6_wkv.py).  Needs 1 <= L <= 32, S % L == 0 and
// P in {16, 32, 64, 128}.  Returns the cudaError_t of the launch.
extern "C" int repro_rwkv6_wkv(
    const void* r, const void* k, const void* v, const void* log_w,
    const void* u, const void* s0, void* y, void* s_out, int B, int S, int H,
    int P, int L, int p_tile, int64_t r_sb, int64_t r_ss, int64_t r_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t w_sb, int64_t w_ss, int64_t w_sh, int64_t y_sb,
    int64_t y_ss, int64_t y_sh, void* stream) {
  // first call, whatever its shape: every instantiation's limit, outside
  // any graph capture that later replays a launch of another shape
  static const cudaError_t smem_ready = raise_all();
  if (smem_ready != cudaSuccess) return (int)smem_ready;
  if (B <= 0 || S <= 0 || H <= 0 || L <= 0 || L > kMaxChunk || S % L != 0 ||
      (P != 16 && P != 32 && P != 64 && P != kMaxP) || p_tile <= 0 ||
      P % p_tile != 0)
    return (int)cudaErrorInvalidValue;
  for (const Variant& var : kVariants) {
    if (var.pt != p_tile) continue;
    var.fn<<<B * H * (P / p_tile), kThreads, smem_bytes(P, p_tile, L),
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(log_w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(y), static_cast<float*>(s_out), S, H, P, L, r_sb,
        r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh,
        y_sb, y_ss, y_sh);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
